// K1: sparse convolution as an output-stationary gather-GEMM with the kernel
// map built in the kernel; K3 (below): its weight gradient.
//
// Replaces the TPU kernel cagroup3d_tpu/ops/pallas_conv.py::_conv_kernel
// (launched by _pallas_forward; forms subm_conv_classes_mxu, subm_conv_mxu and
// conv_at_coords_mxu).  It computes, per group g and query q,
//   out[g, q] = sum_{o in K^3} feats[g, row(key(q) + o)] @ W[g mod Gw, o]
// over a source table whose rows are sorted by packed key, invalid rows
// (INVALID_KEY) last -- the tables of the main path are built that way, as the
// Pallas kernel requires -- so a key's rank is its row.  Missing neighbours
// add nothing and invalid queries give zero rows.  Submanifold convs pass the
// source keys as the queries; conv-at-coords passes a separate query table.
//
// What bounds it on Hopper: at C = 64 (the head's k9/k5 convs and the RoI grid
// conv) the gathered bytes -- each (query, offset) hit reads a 128-byte row at
// a random address; at the backbone's 256/512-channel convs the FLOPs.
// Design:
//   * a block owns 64 queries of one group and 64 output channels;
//   * kernel map in the block: for each (dx, dy) one binary search of the
//     query key shifted by (dx, dy, -h) in the sorted source keys, then a
//     forward scan finds the K dz neighbours, which are contiguous in key
//     order because z is the least significant key field; range checks on the
//     x/y/z digits stop a shifted key from aliasing another column;
//   * (dx, dy, dz) planes with no hit in the tile are skipped, which is most
//     of them for the sparse per-class k9 maps;
//   * per plane, the 64 neighbour rows are gathered (16-byte loads where
//     aligned) into shared memory in 32-channel chunks, and four warps
//     multiply them by the [32, 64] weight slice on the tensor cores (WMMA,
//     bf16 in, f32 accumulate in registers).
// Simple before fast: no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int INVALID_KEY = (1 << 30) + 1;
constexpr int TQ = 64;       // queries per block
constexpr int TN = 64;       // output channels per block
constexpr int KC = 32;       // input-channel chunk
constexpr int KMAX = 9;      // largest kernel edge
constexpr int LDA = KC + 8;  // padded smem leading dims (multiples of 8)
constexpr int LDB = TN + 8;
constexpr int LDC = TN + 4;
constexpr int THREADS = 128;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
sparse_conv_kernel(const int* __restrict__ sk, const int* __restrict__ qk,
                   const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                   int N, int NQ, int C, int Cout, int Gw, int K, int sx, int sy,
                   int ex, int ey, int ez) {
  const int g = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int h = K / 2;
  const int* gsk = sk + (size_t)g * N;
  const __nv_bfloat16* gfeat = feats + (size_t)g * N * C;
  const __nv_bfloat16* gw = w + (size_t)(g % Gw) * K * K * K * C * Cout;
  const bool vec_a = (C % 8 == 0) && ((uintptr_t)feats % 16 == 0);
  const bool vec_b = (Cout % 8 == 0) && ((uintptr_t)w % 16 == 0);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  __shared__ __align__(128) __nv_bfloat16 As[TQ * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[KC * LDB];
  __shared__ __align__(128) float Cs[TQ * LDC];
  __shared__ int nb[KMAX][TQ];
  __shared__ int s_mask;

  // threads 0..TQ-1 own one query each
  int key = INVALID_KEY, xd = 0, yd = 0, zd = 0;
  if (tid < TQ && q0 + tid < NQ) {
    key = qk[(size_t)g * NQ + q0 + tid];
    xd = key >> sx;
    yd = (key >> sy) & (ey - 1);
    zd = key & (ez - 1);
  }
  const bool qvalid = key != INVALID_KEY;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TN / 16];
#pragma unroll
  for (int j = 0; j < TN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int dxi = 0; dxi < K; ++dxi) {
    for (int dyi = 0; dyi < K; ++dyi) {
      if (tid == 0) s_mask = 0;
      __syncthreads();
      if (tid < TQ) {
        const int dx = dxi - h, dy = dyi - h;
        const bool okxy = qvalid && xd + dx >= 0 && xd + dx < ex &&
                          yd + dy >= 0 && yd + dy < ey;
        const int base = key + dx * (1 << sx) + dy * (1 << sy);
        int pos = okxy ? lower_bound(gsk, N, base - h) : N;
        int mask = 0;
        for (int j = 0; j < K; ++j) {
          const int dz = j - h, t = base + dz;
          int r = -1;
          if (okxy && zd + dz >= 0 && zd + dz < ez) {
            while (pos < N && gsk[pos] < t) ++pos;
            if (pos < N && gsk[pos] == t) r = pos;
          }
          nb[j][tid] = r;
          if (r >= 0) mask |= 1 << j;
        }
        if (mask) atomicOr(&s_mask, mask);
      }
      __syncthreads();
      const int mask = s_mask;

      for (int j = 0; j < K; ++j) {
        if (!((mask >> j) & 1)) continue;
        const __nv_bfloat16* wo =
            gw + (size_t)((dxi * K + dyi) * K + j) * C * Cout;
        for (int c0 = 0; c0 < C; c0 += KC) {
          // A: the tile's neighbour rows, channels [c0, c0 + KC)
          for (int e = tid; e < TQ * (KC / 8); e += THREADS) {
            const int r = e / (KC / 8), c = c0 + (e % (KC / 8)) * 8;
            const int row = nb[j][r];
            __nv_bfloat16* dst = &As[r * LDA + (e % (KC / 8)) * 8];
            if (row >= 0 && vec_a && c + 8 <= C) {
              *reinterpret_cast<uint4*>(dst) =
                  *reinterpret_cast<const uint4*>(gfeat + (size_t)row * C + c);
            } else {
#pragma unroll
              for (int u = 0; u < 8; ++u)
                dst[u] = (row >= 0 && c + u < C) ? gfeat[(size_t)row * C + c + u]
                                                 : zero;
            }
          }
          // B: weight rows [c0, c0 + KC), columns [n0, n0 + TN)
          for (int e = tid; e < KC * (TN / 8); e += THREADS) {
            const int r = e / (TN / 8), c = c0 + r, n = n0 + (e % (TN / 8)) * 8;
            __nv_bfloat16* dst = &Bs[r * LDB + (e % (TN / 8)) * 8];
            if (c < C && vec_b && n + 8 <= Cout) {
              *reinterpret_cast<uint4*>(dst) =
                  *reinterpret_cast<const uint4*>(wo + (size_t)c * Cout + n);
            } else {
#pragma unroll
              for (int u = 0; u < 8; ++u)
                dst[u] = (c < C && n + u < Cout) ? wo[(size_t)c * Cout + n + u]
                                                 : zero;
            }
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, &As[warp * 16 * LDA + kk], LDA);
#pragma unroll
            for (int jn = 0; jn < TN / 16; ++jn) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> b;
              wmma::load_matrix_sync(b, &Bs[kk * LDB + jn * 16], LDB);
              wmma::mma_sync(acc[jn], a, b, acc[jn]);
            }
          }
          __syncthreads();
        }
      }
    }
  }

#pragma unroll
  for (int jn = 0; jn < TN / 16; ++jn)
    wmma::store_matrix_sync(&Cs[warp * 16 * LDC + jn * 16], acc[jn], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TQ * TN; e += THREADS) {
    const int r = e / TN, c = e % TN, q = q0 + r, n = n0 + c;
    if (q < NQ && n < Cout) out[((size_t)g * NQ + q) * Cout + n] = Cs[r * LDC + c];
  }
}

// K3: the weight gradient of K1.
//
// Replaces the TPU kernel cagroup3d_tpu/ops/pallas_conv.py::_dw_kernel
// (launched by _pallas_dw from the custom VJPs of subm_conv_classes_mxu and
// conv_at_coords_mxu).  It computes, per weight group gw and offset o,
//   dW[gw, o] = sum_{g mod Gw == gw} sum_q feats[g, row(key(q) + o)]^T gout[g, q]
// over the same key-sorted source tables as K1 (invalid queries and missing
// neighbours add nothing), bf16 in, f32 out.
//
// What bounds it on Hopper: at the head's per-class k9 form every one of the
// 18 x 729 offsets owns a 64 x 64 f32 tile of dW, so writing dW (215 MB) is a
// floor; at the backbone's 256/512-channel convs the FLOPs; in between the
// row gathers, as in K1.
// Design:
//   * a block owns one (group, offset, 64-row C tile, 64-column Cout tile)
//     and a chunk of queries; the chunk count is chosen on the host so that
//     the grid fills the card (small tables with few offsets, such as the
//     backbone's 65536-row k3 convs, are split into many chunks);
//   * kernel map in the block: per query one binary search of key + offset in
//     the sorted source keys, with the x/y/z digit range checks of K1; chunks
//     of 64 queries with no hit are skipped (most of them at k9);
//   * per 64-query step the hit rows of feats and the matching gout rows are
//     gathered into shared memory and four warps accumulate feats^T gout on
//     the tensor cores (WMMA, bf16 in, f32 accumulate in registers);
//   * with one chunk and one group per weight group the block writes dW
//     directly; otherwise it writes its partial tile and a second kernel sums
//     the partials in a fixed order (groups ascending, then chunks), with no
//     float atomics, so two runs give the same bits.
// Simple before fast: the binary searches are repeated per C/Cout tile and no
// cp.async/TMA pipelining or wgmma yet.

constexpr int DTC = 64;              // C rows of dW per block
constexpr int DTQ = 64;              // queries per step
constexpr int DLDA = DTC + 8;
constexpr int DLDB = TN + 8;
constexpr int DLDC = TN + 4;
constexpr int DW_TARGET_BLOCKS = 132 * 16;

struct DwPlan {
  int ctiles, ntiles, nchunk, qchunk;
  bool direct;
};

DwPlan dw_plan(int G, int NQ, int C, int Cout, int K, int Gw) {
  DwPlan p;
  p.ctiles = (C + DTC - 1) / DTC;
  p.ntiles = (Cout + TN - 1) / TN;
  const long long per_chunk = (long long)G * K * K * K * p.ctiles * p.ntiles;
  const int steps = NQ > 0 ? (NQ + DTQ - 1) / DTQ : 1;
  long long want = (DW_TARGET_BLOCKS + per_chunk - 1) / per_chunk;
  if (want > steps) want = steps;
  if (want < 1) want = 1;
  const int steps_per_chunk = (int)((steps + want - 1) / want);
  p.qchunk = steps_per_chunk * DTQ;
  p.nchunk = (steps + steps_per_chunk - 1) / steps_per_chunk;
  p.direct = p.nchunk == 1 && G == Gw;
  return p;
}

__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_kernel(const int* __restrict__ sk, const int* __restrict__ qk,
                      const __nv_bfloat16* __restrict__ feats,
                      const __nv_bfloat16* __restrict__ gout,
                      float* __restrict__ dst, int G, int N, int NQ, int C,
                      int Cout, int K, int qchunk, int ctiles, int ntiles,
                      int sx, int sy, int ex, int ey, int ez) {
  const int chunk = blockIdx.x;
  const int o = blockIdx.y;
  int z = blockIdx.z;
  const int nt = z % ntiles;
  z /= ntiles;
  const int ct = z % ctiles;
  const int g = z / ctiles;
  const int c0 = ct * DTC, n0 = nt * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int h = K / 2, K3 = K * K * K;
  const int dx = o / (K * K) - h, dy = (o / K) % K - h, dz = o % K - h;
  const int delta = dx * (1 << sx) + dy * (1 << sy) + dz;
  const int* gsk = sk + (size_t)g * N;
  const int* gqk = qk + (size_t)g * NQ;
  const __nv_bfloat16* gfeat = feats + (size_t)g * N * C;
  const __nv_bfloat16* ggout = gout + (size_t)g * NQ * Cout;
  const bool vec_a = (C % 8 == 0) && ((uintptr_t)feats % 16 == 0);
  const bool vec_b = (Cout % 8 == 0) && ((uintptr_t)gout % 16 == 0);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  __shared__ __align__(128) __nv_bfloat16 As[DTQ * DLDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[DTQ * DLDB];
  __shared__ __align__(128) float Cs[DTC * DLDC];
  __shared__ int nb[DTQ];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TN / 16];
#pragma unroll
  for (int j = 0; j < TN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int q_begin = chunk * qchunk;
  const int q_end = min(NQ, q_begin + qchunk);
  for (int q0 = q_begin; q0 < q_end; q0 += DTQ) {
    int r = -1;
    if (tid < DTQ && q0 + tid < q_end) {
      const int key = gqk[q0 + tid];
      if (key != INVALID_KEY) {
        const int xd = key >> sx, yd = (key >> sy) & (ey - 1),
                  zd = key & (ez - 1);
        if (xd + dx >= 0 && xd + dx < ex && yd + dy >= 0 && yd + dy < ey &&
            zd + dz >= 0 && zd + dz < ez) {
          const int t = key + delta;
          const int pos = lower_bound(gsk, N, t);
          if (pos < N && gsk[pos] == t) r = pos;
        }
      }
    }
    if (tid < DTQ) nb[tid] = r;
    if (!__syncthreads_or(r >= 0)) continue;

    // A: hit rows of feats, channels [c0, c0 + DTC)
    for (int e = tid; e < DTQ * (DTC / 8); e += THREADS) {
      const int rr = e / (DTC / 8), c = c0 + (e % (DTC / 8)) * 8;
      const int row = nb[rr];
      __nv_bfloat16* d = &As[rr * DLDA + (e % (DTC / 8)) * 8];
      if (row >= 0 && vec_a && c + 8 <= C) {
        *reinterpret_cast<uint4*>(d) =
            *reinterpret_cast<const uint4*>(gfeat + (size_t)row * C + c);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          d[u] = (row >= 0 && c + u < C) ? gfeat[(size_t)row * C + c + u]
                                         : zero;
      }
    }
    // B: gout rows of the queries with a hit, columns [n0, n0 + TN)
    for (int e = tid; e < DTQ * (TN / 8); e += THREADS) {
      const int rr = e / (TN / 8), n = n0 + (e % (TN / 8)) * 8;
      const bool hit = nb[rr] >= 0;
      const size_t q = (size_t)(q0 + rr);
      __nv_bfloat16* d = &Bs[rr * DLDB + (e % (TN / 8)) * 8];
      if (hit && vec_b && n + 8 <= Cout) {
        *reinterpret_cast<uint4*>(d) =
            *reinterpret_cast<const uint4*>(ggout + q * Cout + n);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          d[u] = (hit && n + u < Cout) ? ggout[q * Cout + n + u] : zero;
      }
    }
    __syncthreads();
    // acc[c, n] += sum_q A[q, c] * B[q, n]: A^T read as a col-major matrix_a
#pragma unroll
    for (int kk = 0; kk < DTQ; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a;
      wmma::load_matrix_sync(a, &As[kk * DLDA + warp * 16], DLDA);
#pragma unroll
      for (int jn = 0; jn < TN / 16; ++jn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[kk * DLDB + jn * 16], DLDB);
        wmma::mma_sync(acc[jn], a, b, acc[jn]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jn = 0; jn < TN / 16; ++jn)
    wmma::store_matrix_sync(&Cs[warp * 16 * DLDC + jn * 16], acc[jn], DLDC,
                            wmma::mem_row_major);
  __syncthreads();
  // dst: [nchunk][G][K3][C][Cout] partials, or dW itself when direct
  float* out = dst + (((size_t)chunk * G + g) * K3 + o) * C * Cout;
  for (int e = tid; e < DTC * TN; e += THREADS) {
    const int c = c0 + e / TN, n = n0 + e % TN;
    if (c < C && n < Cout) out[(size_t)c * Cout + n] = Cs[(e / TN) * DLDC + e % TN];
  }
}

// dW[gw, o, c, n] = sum over groups g = gw, gw + Gw, ... (ascending) and
// then chunks (ascending) of the partial tiles: a fixed order.
__global__ void sparse_conv_dw_reduce(const float* __restrict__ part,
                                      float* __restrict__ out, int G, int Gw,
                                      int nchunk, long long per_group) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Gw * per_group) return;
  const int gw = (int)(i / per_group);
  const long long e = i % per_group;
  float s = 0.f;
  for (int g = gw; g < G; g += Gw)
    for (int c = 0; c < nchunk; ++c)
      s += part[((long long)c * G + g) * per_group + e];
  out[i] = s;
}

}  // namespace

// Floats of partial scratch that sparse_conv_dw_launch needs (0: none).
extern "C" long long sparse_conv_dw_plan(int G, int NQ, int C, int Cout,
                                         int K, int Gw) {
  const DwPlan p = dw_plan(G, NQ, C, Cout, K, Gw);
  if (p.direct) return 0;
  return (long long)p.nchunk * G * K * K * K * C * Cout;
}

extern "C" int sparse_conv_dw_launch(const void* sk, const void* qk,
                                     const void* feats, const void* gout,
                                     void* part, void* out, int G, int N,
                                     int NQ, int C, int Cout, int Gw, int K,
                                     int sx, int sy, int ex, int ey, int ez,
                                     void* stream) {
  if (K > KMAX || K % 2 == 0 || Gw <= 0 || G % Gw != 0)
    return (int)cudaErrorInvalidValue;
  const DwPlan p = dw_plan(G, NQ, C, Cout, K, Gw);
  const int K3 = K * K * K;
  const long long per_group = (long long)K3 * C * Cout;
  cudaStream_t st = (cudaStream_t)stream;
  if (NQ == 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * Gw * per_group, st);
    return (int)cudaGetLastError();
  }
  const dim3 grid(p.nchunk, K3, G * p.ctiles * p.ntiles);
  sparse_conv_dw_kernel<<<grid, THREADS, 0, st>>>(
      (const int*)sk, (const int*)qk, (const __nv_bfloat16*)feats,
      (const __nv_bfloat16*)gout, (float*)(p.direct ? out : part), G, N, NQ,
      C, Cout, K, p.qchunk, p.ctiles, p.ntiles, sx, sy, ex, ey, ez);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.direct) return (int)err;
  const long long total = (long long)Gw * per_group;
  const int threads = 256;
  sparse_conv_dw_reduce<<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, st>>>((const float*)part, (float*)out,
                                            G, Gw, p.nchunk, per_group);
  return (int)cudaGetLastError();
}

extern "C" int sparse_conv_launch(const void* sk, const void* qk,
                                  const void* feats, const void* w, void* out,
                                  int G, int N, int NQ, int C, int Cout, int Gw,
                                  int K, int sx, int sy, int ex, int ey, int ez,
                                  void* stream) {
  if (K > KMAX || K % 2 == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((NQ + TQ - 1) / TQ, (Cout + TN - 1) / TN, G);
  sparse_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)sk, (const int*)qk, (const __nv_bfloat16*)feats,
      (const __nv_bfloat16*)w, (float*)out, N, NQ, C, Cout, Gw, K, sx, sy, ex,
      ey, ez);
  return (int)cudaGetLastError();
}
