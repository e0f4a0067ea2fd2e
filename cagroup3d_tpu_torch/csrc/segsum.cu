// K2: sorted-run segment sums for the dense head's per-class fine maps.
//
// Replaces the TPU kernel cagroup3d_tpu/ops/pallas_segsum.py::_segsum_kernel.
// Per group g, over key-sorted rows (INVALID_KEY last): sums[g, j, :] is the
// f32 sum of the bf16 feature rows of the j-th run of equal keys and
// counts[g, j] its row count, for runs j < cap.
//
// What bounds it on Hopper: bytes.  Each needed row is read once (2F bytes),
// and under capacity overflow (the normal case at full caps) only the rows
// of runs < cap are needed (712,581 of 1.18M rows at the main-path call).
// Design: a parallel reduce-by-key in two passes over row tiles, no float
// atomics:
//   1. k2_count: a grid over (row tile of TILE rows, group); each block
//      counts its tile's run heads (valid and key != previous key) and valid
//      rows and finds its first head.
//   2. k2_reduce: the same grid.  Each block sums the head counts of the
//      tiles before it (its first run id) and of the whole group.  Blocks
//      whose first run id is >= cap exit at once, so the early stop is
//      parallel.  The others rank their heads with a block scan; a run ends
//      at the next head, or for the tile's last run at the first head of a
//      later tile or the first invalid row.  A warp takes one run with
//      known bounds: at F 64, 8 lanes cover a row with one 16-byte load of
//      8 features each, four rows side by side and four such in flight;
//      the f32 partial sums of the row groups are added in a fixed tree and
//      the run's sums and exact count written.  Runs past the total are
//      written as zeros, spread over the group's blocks.
// Every output is written once, its sum taken in a fixed order: two calls
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INVALID_KEY = (1 << 30) + 1;
constexpr int TILE = 256;            // rows per block
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int RPT = TILE / THREADS;  // rows per thread in the head passes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ bool is_head(const int* keys, int i) {
  const int k = keys[i];
  return k != INVALID_KEY && (i == 0 || keys[i - 1] != k);
}

// Per tile: its run heads, the row of its first head (P if none) and its
// valid rows, at tile_info[(g * ntiles + t) * 3 + 0, 1, 2].
__global__ void __launch_bounds__(THREADS)
segsum_k2_count(const int* __restrict__ sk, int* __restrict__ tile_info,
                int P, int ntiles) {
  __shared__ int s_red[NWARP];
  const int g = blockIdx.y, t = blockIdx.x;
  const int* keys = sk + (size_t)g * P;
  int heads = 0, first = P, valid = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = t * TILE + j * THREADS + threadIdx.x;
    if (i < P) {
      const bool h = is_head(keys, i);
      heads += h;
      first = h ? min(first, i) : first;
      valid += keys[i] != INVALID_KEY;
    }
  }
  heads = block_sum(heads, s_red);
  valid = block_sum(valid, s_red);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    first = min(first, __shfl_xor_sync(FULL, first, o));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NWARP; ++w) first = min(first, s_red[w]);
    int* info = tile_info + ((size_t)g * ntiles + t) * 3;
    info[0] = heads;
    info[1] = first;
    info[2] = valid;
  }
}

// Runs in rank order, one warp a run.  L lanes cover a row (32 / L rows at
// a time, four such rows each in flight): with vector loads a lane sums 8
// features of its rows (one 16-byte load a row), else one lane per 32nd
// feature; the row groups' partial sums are then added in a fixed tree.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
segsum_k2_reduce(const int* __restrict__ sk,
                 const __nv_bfloat16* __restrict__ feats,
                 const int* __restrict__ tile_info, float* __restrict__ sums,
                 int* __restrict__ counts, int P, int F, int cap, int ntiles,
                 int L) {
  __shared__ int s_red[NWARP];
  __shared__ int s_scan[NWARP];
  __shared__ int s_row[TILE + 1];  // rows of the tile's heads, then the end
  const int g = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* keys = sk + (size_t)g * P;
  const int* info = tile_info + (size_t)g * ntiles * 3;
  const __nv_bfloat16* rows = feats + (size_t)g * P * F;
  float* gsum = sums + (size_t)g * cap * F;
  int* gcnt = counts + (size_t)g * cap;

  // first run id of the tile, the group's run total and valid rows, and the
  // first head after the tile (where its last run ends, unless rows turn
  // invalid first)
  int before = 0, all = 0, nvalid = 0, next = P;
  for (int u = tid; u < ntiles; u += THREADS) {
    const int h = info[u * 3];
    all += h;
    nvalid += info[u * 3 + 2];
    if (u < t) before += h;
    if (u > t) next = min(next, info[u * 3 + 1]);
  }
  before = block_sum(before, s_red);
  all = block_sum(all, s_red);
  nvalid = block_sum(nvalid, s_red);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    next = min(next, __shfl_xor_sync(FULL, next, o));
  if (lane == 0) s_red[warp] = next;
  __syncthreads();
  for (int w = 0; w < NWARP; ++w) next = min(next, s_red[w]);
  __syncthreads();

  // runs [all, cap) are empty: zero them, a slice per block of the group
  if (all < cap) {
    const int per = (cap - all + ntiles - 1) / ntiles;
    const int j0 = all + t * per, j1 = min(cap, j0 + per);
    for (int e = tid; e < (j1 - j0) * F; e += THREADS)
      gsum[(size_t)j0 * F + e] = 0.f;
    for (int j = j0 + tid; j < j1; j += THREADS) gcnt[j] = 0;
  }
  if (before >= cap) return;  // every run of this tile is past the cap

  // rank the tile's heads: thread tid owns rows r0 .. r0 + RPT - 1
  const int r0 = t * TILE + tid * RPT;
  int flags = 0, n = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const bool h = r0 + j < P && is_head(keys, r0 + j);
    flags |= (int)h << j;
    n += h;
  }
  int x = n;  // inclusive scan over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  int off = 0, tile_total = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    off += w < warp ? s_scan[w] : 0;
    tile_total += s_scan[w];
  }
  int k = off + x - n;  // the tile-local rank of this thread's first head
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if ((flags >> j) & 1) s_row[k++] = r0 + j;
  if (tid == 0) s_row[tile_total] = min(next, nvalid);
  __syncthreads();
  const int kept = min(tile_total, cap - before);

  const int RG = 32 / L, rg = lane / L, gl = lane % L;  // row groups
  const int nf = VEC ? F / 8 : (F + 31) / 32;  // segments (VEC) or features
  for (int r = warp; r < kept; r += NWARP) {
    const int start = s_row[r], end = s_row[r + 1], id = before + r;
    float acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = 0.f;
    if (VEC) {
      if (gl < nf) {
        const __nv_bfloat16* p = rows + (size_t)start * F + gl * 8;
        for (int i = rg; i < end - start; i += 4 * RG) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = i + u * RG < end - start
                       ? *reinterpret_cast<const uint4*>(
                             p + (size_t)(i + u * RG) * F)
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const __nv_bfloat162* b =
                reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float2 f = __bfloat1622float2(b[c]);
              acc[2 * c] += f.x;
              acc[2 * c + 1] += f.y;
            }
          }
        }
      }
    } else {
      for (int i = start; i < end; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nf && gl + 32 * u < F)
            acc[u] += __bfloat162float(rows[(size_t)i * F + gl + 32 * u]);
    }
    for (int o = L; o < 32; o <<= 1)  // row groups, in a fixed tree
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] += __shfl_xor_sync(FULL, acc[u], o);
    if (rg == 0) {
      if (VEC && gl < nf) {
        float4* o = reinterpret_cast<float4*>(gsum + (size_t)id * F + gl * 8);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else if (!VEC) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nf && gl + 32 * u < F)
            gsum[(size_t)id * F + gl + 32 * u] = acc[u];
      }
      if (gl == 0) gcnt[id] = end - start;
    }
  }
}

}  // namespace

// Rows per block of both passes.
extern "C" int segsum_tile_rows() { return TILE; }

// int32 scratch that segsum_launch needs: three per (group, tile).
extern "C" long long segsum_scratch(int G, int P) {
  return 3LL * G * ((P + TILE - 1) / TILE);
}

extern "C" int segsum_launch(const void* sk, const void* feats, void* sums,
                             void* counts, void* scratch, int G, int P, int F,
                             int cap, void* stream) {
  if (G <= 0 || P <= 0 || F <= 0 || F > 256 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (P + TILE - 1) / TILE;
  const dim3 grid(ntiles, G);
  segsum_k2_count<<<grid, THREADS, 0, st>>>((const int*)sk, (int*)scratch, P,
                                            ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = F % 8 == 0 && (uintptr_t)feats % 16 == 0;
  int L = 32;  // lanes a run: the power of two that covers F / 8 segments
  if (vec)
    for (L = 1; L < F / 8; L <<= 1) {
    }
  if (vec)
    segsum_k2_reduce<true><<<grid, THREADS, 0, st>>>(
        (const int*)sk, (const __nv_bfloat16*)feats, (const int*)scratch,
        (float*)sums, (int*)counts, P, F, cap, ntiles, L);
  else
    segsum_k2_reduce<false><<<grid, THREADS, 0, st>>>(
        (const int*)sk, (const __nv_bfloat16*)feats, (const int*)scratch,
        (float*)sums, (int*)counts, P, F, cap, ntiles, L);
  return (int)cudaGetLastError();
}
