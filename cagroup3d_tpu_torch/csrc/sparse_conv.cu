// K1: sparse convolution as a pipelined gather-GEMM over a kernel map that
// a block builds once and shares across its output-column tiles; K3 (below):
// its weight gradient.
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
// The feature backward is the same kernel with offset-reversed, transposed
// weights, read in place (BT: the weight slice is [Cout][C]).
//
// What bounds it on Hopper.  The bound (the hits' FLOPs, or each input read
// once) is tens of µs a call; what the kernel meets first is issue and
// latency: a 64-query tile meets up to K^3 offsets with a few hits each, so
// the work is many small gather-GEMM steps (at the head's k9 form about 490
// a block, each with 64 x 64 x 64 MACs and an 8 KB weight slice), and each
// step's instruction count, barrier and gather latency set the time.
// Design:
//   * k1_prep, one launch: the packed keys of both tables, the bf16 source
//     rows (invalid rows zeroed, channels padded to a multiple of 16) and the
//     bf16 weights (last two axes padded), so the wrapper launches no
//     PyTorch kernel and C = 3 takes the tensor-core path as C = 16;
//   * a block (8 warps) owns 64 queries of one group, a range of kernel
//     offsets (the split: when the grid would be under two waves of 132 SMs
//     the offsets are divided over blocks and k1_reduce sums the partial
//     tiles in split order) and a range of 64- or 128-column tiles, which it
//     walks with one kernel map;
//   * the kernel map, built once in the block: the tile's queries span a
//     narrow key range (key-sorted tables), so per dx slab two warp-wide
//     32-ary searches bound the window of source keys the tile can reach;
//     the window is staged in shared memory and each (query, dy) searches it
//     once and scans its contiguous dz neighbours.  An entry packs, per
//     (dx, dy) plane and query, the first neighbour's row and a bit per dz
//     (K^2 x 64 ints: the whole map stays in shared memory even at K 9),
//     and the live offsets -- most k9 offsets of a tile are empty -- are
//     listed in offset order with their 16-row groups that have a hit;
//   * gather-GEMM: for each (live offset, 64-channel chunk) item a pipeline
//     stage gathers the 64 neighbour rows (cp.async 16-byte copies,
//     zero-filled for missing rows, none for 16-row groups without a hit)
//     and the weight slice; a stage holds two items under one barrier, and
//     the copies of the next stage overlap the tensor-core work on the
//     current one (mma.sync m16n8k16 bf16, f32 accumulators in registers;
//     a warp owns 16 rows and skips items where they have no hit).  Each
//     thread's copies are fixed, so an item costs a few instructions per
//     copy: the instructions and the barrier of each step, not the memory
//     system, are what set the time;
//   * no float atomics: two calls give the same bits.
// mma.sync, not wgmma: a step's A tile is 64 gathered rows, which no TMA copy
// can fetch, and the steps are too small for the tensor cores to set the
// time; wgmma is left to the K3 redesign, where dW tiles are dense.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INVALID_KEY = (1 << 30) + 1;
constexpr int KMAX = 9;      // largest kernel edge
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index of a[0, n) that is >= t; every lane of the warp calls it with
// the same arguments and gets the answer.  Each round probes 32 evenly spaced
// keys, so ~4 dependent loads cover 65536 keys.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int t, int lane) {
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const int c = __popc(__ballot_sync(FULL, i < hi && a[i] < t));
    const int nlo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = min(hi, lo + c * step);
    lo = nlo;
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(FULL, i < hi && a[i] < t));
}

__device__ __forceinline__ int pack_key(const int* lat, bool valid, int margin,
                                        int sx, int sy, int ex, int ey,
                                        int ez) {
  const int x = lat[0] + margin, y = lat[1] + margin, z = lat[2] + margin;
  const bool in = x >= 0 && x < ex && y >= 0 && y < ey && z >= 0 && z < ez;
  return valid && in ? (x << sx) | (y << sy) | z : INVALID_KEY;
}

// ---------------------------------------------------------------- K1 -----

constexpr int K1_TQ = 64;          // queries per block
constexpr int K1_THREADS = 256;    // 8 warps
constexpr int K1_KC = 64;          // input channels per pipeline step
constexpr int K1_LDA = K1_KC + 8;  // smem row stride (bf16) of A, and of B^T
constexpr int K1_NSTAGE = 2;       // pipeline stages
constexpr int K1_ITEMS = 2;        // (offset, channel chunk) items a stage
constexpr int K1_WCAP = 2048;      // source keys of a staged window

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight f32 values from row[c0, c0 + 8) (zeros past n or where !ok), rounded
// to bf16 and packed for one 16-byte store.
__device__ __forceinline__ uint4 bf16x8(const float* row, int c0, int n,
                                        bool ok, bool vec) {
  float v[8];
  if (ok && vec && c0 + 8 <= n) {
    const float4 x = *reinterpret_cast<const float4*>(row + c0);
    const float4 y = *reinterpret_cast<const float4*>(row + c0 + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = ok && c0 + u < n ? row[c0 + u] : 0.f;
  }
  uint4 r;
  uint32_t* p = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
    p[u] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return r;
}

// One launch of operand preparation: source (and query) keys, bf16 source
// rows [G, N, Cp] with invalid rows zeroed, bf16 weights [Gw*K^3, Rp, Sp];
// rows and weights go 8 values (one 16-byte store) per item.
__global__ void spconv_k1_prep(const int* __restrict__ slat,
                               const uint8_t* __restrict__ svalid,
                               const float* __restrict__ feats,
                               const int* __restrict__ qlat,
                               const uint8_t* __restrict__ qvalid,
                               const float* __restrict__ w, int* sk, int* qk,
                               __nv_bfloat16* fb, __nv_bfloat16* wb, int nsrc,
                               int nqry, int C, int Cp, int nslice, int R,
                               int S, int Rp, int Sp, int margin, int sx,
                               int sy, int ex, int ey, int ez) {
  const int fg = Cp / 8, wg = Sp / 8;
  const int nf = nsrc * fg, total = nsrc + nqry + nf + nslice * Rp * wg;
  const bool fvec = C % 4 == 0, wvec = S % 4 == 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int j = i;
    if (j < nsrc) {
      sk[j] = pack_key(slat + 3 * j, svalid[j], margin, sx, sy, ex, ey, ez);
    } else if ((j -= nsrc) < nqry) {
      qk[j] = pack_key(qlat + 3 * j, qvalid[j], margin, sx, sy, ex, ey, ez);
    } else if ((j -= nqry) < nf) {
      const int r = j / fg, c0 = (j - r * fg) * 8;
      *reinterpret_cast<uint4*>(fb + (size_t)r * Cp + c0) =
          bf16x8(feats + (size_t)r * C, c0, C, svalid[r], fvec);
    } else {
      j -= nf;
      const int t = j / wg, s0 = (j - t * wg) * 8, r = t % Rp, a = t / Rp;
      *reinterpret_cast<uint4*>(wb + (size_t)t * Sp + s0) =
          bf16x8(w + ((size_t)a * R + r) * S, s0, S, r < R, wvec);
    }
  }
}

struct K1Args {
  const int* sk;
  const int* qk;
  const __nv_bfloat16* fb;  // [G, N, Cp]
  const __nv_bfloat16* wb;  // [Gw, K^3, wr, ws]: [Cp, Coutp], or BT [Coutp, Cp]
  float* out;               // [split, G, NQ, Cout] (out itself when split 1)
  int N, NQ, Cp, Cout, Gw, K, wr, ws;
  int col_inner, split, per_split;
  int sx, sy, ex, ey, ez;
};

// Shared memory of a block: K1_NSTAGE stages of K1_ITEMS tiles of A
// [TQ][LDA] and of B ([KC][TN + 8], or B^T [TN][LDA]), then ints: the map
// [K^2][TQ], the offsets' row-group masks, the live list and its step info
// [K^3] each, the staged window, the tile's query keys, the slab windows and
// a few reduction slots.
template <int TN, bool BT>
struct K1Smem {
  static constexpr int TQ = K1_TQ, NST = K1_NSTAGE, IT = K1_ITEMS;
  static constexpr int A = NST * IT * TQ * K1_LDA;  // bf16 elements
  static constexpr int B = NST * IT * (BT ? TN * K1_LDA : K1_KC * (TN + 8));
  static size_t bytes(int K) {
    return 2 * (size_t)(A + B) + 4 * ((size_t)K * K * TQ + 3 * K * K * K +
                                      K1_WCAP + TQ + 2 * KMAX + 16);
  }
};

// Issue the cp.async copies of one pipeline step -- the TQ neighbour rows of
// a live offset o (zero-filled where missing; 16-row groups without a
// neighbour, which the MMA skips, not at all), channels [c0, c0 + KC), and
// the offset's weight slice -- into one stage.  `info` locates the offset's
// plane in the map and its dz.  A map entry packs, per (dx, dy) plane and
// query, the row of the first of the plane's dz neighbours that exist
// (sorted keys: they are consecutive rows) and a bit per dz, so neighbour dz
// is at row + popc(bits below dz).  Each thread's rows and segments are
// fixed, so a step costs a few instructions per copy.
template <int TN, bool BT>
__device__ __forceinline__ void k1_load(const K1Args& a, const int* s_map,
                                        int info, int o, int c0, int n0,
                                        const __nv_bfloat16* gf,
                                        const __nv_bfloat16* gw, int K3,
                                        __nv_bfloat16* As, __nv_bfloat16* Bs,
                                        int tid) {
  constexpr int TQ = K1_TQ, THREADS = K1_THREADS;
  const int pbase = info & 0x3fff, dz = (info >> 14) & 15;
  const unsigned below = (1u << dz) - 1;
  const int seg = (tid & 7) * 8, c = c0 + seg;
  if (c < a.Cp) {
#pragma unroll
    for (int j = 0; j < TQ * 8 / THREADS; ++j) {
      const int r = (tid >> 3) + j * (THREADS / 8);
      if (!((info >> (18 + (r >> 4))) & 1)) continue;  // MMA skips these rows
      const int e = s_map[pbase + r];
      const bool hit = (e >> dz) & 1;
      const int row = (e >> 9) + __popc(e & below);
      cp_async16(As + r * K1_LDA + seg,
                 hit ? gf + ((size_t)row * a.Cp + c) : gf, hit ? 16 : 0);
    }
  }
  const __nv_bfloat16* wo = gw + (size_t)(BT ? K3 - 1 - o : o) * a.wr * a.ws;
  if (BT) {  // wo [n][c]: B^T tile [TN][KC]
    if (c < a.Cp) {
#pragma unroll
      for (int j = 0; j < TN * 8 / THREADS; ++j) {
        const int nn = (tid >> 3) + j * (THREADS / 8);
        if (n0 + nn < a.wr)
          cp_async16(Bs + nn * K1_LDA + seg,
                     wo + ((size_t)(n0 + nn) * a.ws + c), 16);
      }
    }
  } else {  // wo [c][n]: B tile [KC][TN]
    constexpr int SEGS = TN / 8;
    const int nseg = (tid % SEGS) * 8, n = n0 + nseg;
    if (n < a.ws) {
#pragma unroll
      for (int j = 0; j < K1_KC * SEGS / THREADS; ++j) {
        const int k = tid / SEGS + j * (THREADS / SEGS);
        if (c0 + k < a.Cp)
          cp_async16(Bs + k * (TN + 8) + nseg,
                     wo + ((size_t)(c0 + k) * a.ws + n), 16);
      }
    }
  }
}

// acc += A[the warp's 16 rows, 0:KD] @ B[0:KD, the warp's TN / 2 columns].
template <int TN, bool BT, int KD>
__device__ __forceinline__ void k1_mma(float (&acc)[TN / 16][4],
                                       const __nv_bfloat16* As,
                                       const __nv_bfloat16* Bs, int wm, int wn,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, As + (wm * 16 + (lane & 15)) * K1_LDA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < TN / 32; ++nj) {
      const int nb = wn * (TN / 2) + nj * 16;
      uint32_t bf[4];
      if (BT)
        ldsm_x4(bf, Bs + (nb + (lane & 7) + ((lane >> 4) << 3)) * K1_LDA + kk +
                        ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(bf,
                  Bs + (kk + (lane & 15)) * (TN + 8) + nb + (lane >> 4) * 8);
      mma_bf16(acc[2 * nj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nj + 1], af, bf[2], bf[3]);
    }
  }
}

// The map entries of slab dxi's planes for the block's queries: per (dy,
// query) one search of the shifted key in the slab's window win[0, W) of
// source keys (rows lo, lo + 1, ...), then a scan over the plane's dz
// neighbours; and the 16-row groups with a neighbour, per offset in
// [o_begin, o_end).
__device__ __forceinline__ void k1_map_slab(const K1Args& a, const int* win,
                                            int W, int lo, int dxi,
                                            int o_begin, int o_end,
                                            const int* s_qkey, int* s_map,
                                            int* s_mask, int tid, int lane) {
  constexpr int TQ = K1_TQ, THREADS = K1_THREADS;
  const int K = a.K, h = K / 2, dx = dxi - h;
  // a warp takes 32 queries of one dy, so its two 16-lane halves are two
  // 16-row groups of the plane's offsets
  for (int idx = tid; idx < TQ * K; idx += THREADS) {
    const int q = idx % TQ, dyi = idx / TQ;
    const int dy = dyi - h, plane = dxi * K + dyi, obase = plane * K;
    if (obase + K <= o_begin || obase >= o_end) continue;
    const int key = s_qkey[q];
    const int xd = key >> a.sx, yd = (key >> a.sy) & (a.ey - 1),
              zd = key & (a.ez - 1);
    const bool okxy = key != INVALID_KEY && xd + dx >= 0 && xd + dx < a.ex &&
                      yd + dy >= 0 && yd + dy < a.ey;
    // dz neighbours j in [j0, j1) stay in the z range; the entry's row is
    // that of the first key >= the j0 neighbour's, so a key of another
    // column (z out of range) never counts
    const int base = key + dx * (1 << a.sx) + dy * (1 << a.sy) - h;
    const int j0 = max(0, h - zd), j1 = min(K, h + a.ez - zd);
    const int first = okxy ? lower_bound(win, W, base + j0) : W;
    int pos = first;
    unsigned bits = 0;
    if (okxy) {
      for (int j = j0; j < j1; ++j) {
        const int t = base + j;
        while (pos < W && win[pos] < t) ++pos;
        bits |= (unsigned)(pos < W && win[pos] == t) << j;
      }
    }
    // offsets of the block's range with a neighbour, per 16-row group
    const unsigned in = ((1u << min(K, o_end - obase)) - 1) &
                        ~((1u << max(0, o_begin - obase)) - 1);
    const unsigned lo16 = __reduce_or_sync(FULL, lane < 16 ? bits & in : 0u);
    const unsigned hi16 = __reduce_or_sync(FULL, lane < 16 ? 0u : bits & in);
    if (lane == 0)
      for (unsigned m = lo16 | hi16; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        atomicOr(&s_mask[obase + j],
                 (int)(((lo16 >> j) & 1) | ((hi16 >> j) & 1) << 1) << (q >> 4));
      }
    s_map[plane * TQ + q] = (lo + first) << 9 | bits;
  }
}

// The kernel map of offsets [o_begin, o_end) for the TQ queries from q0 of
// group g, built by the whole block: the tile's query keys (s_qkey) and
// their range (min / max valid key), per dx slab the window [lo, hi) of
// source rows the tile can reach, staged in shared memory when it fits,
// then the slab's entries (k1_map_slab).  s_mask is zeroed first; the
// planes of a slab without a window keep what s_map held.
__device__ __forceinline__ void k1_block_map(const K1Args& a, int g, int q0,
                                             int o_begin, int o_end,
                                             int* s_map, int* s_mask,
                                             int* s_win, int* s_qkey,
                                             int* s_lo, int* s_hi, int* s_red,
                                             int tid, int lane, int warp) {
  constexpr int TQ = K1_TQ, THREADS = K1_THREADS;
  const int K = a.K, KK = K * K, K3 = KK * K, h = K / 2;
  const int slab_begin = o_begin / KK, slab_end = (o_end + KK - 1) / KK;
  const int* gsk = a.sk + (size_t)g * a.N;
  if (tid < TQ) {
    const int key = q0 + tid < a.NQ ? a.qk[(size_t)g * a.NQ + q0 + tid]
                                    : INVALID_KEY;
    s_qkey[tid] = key;
    int kmin = key, kmax = key != INVALID_KEY ? key : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(FULL, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(FULL, kmax, o));
    }
    if (lane == 0) {
      s_red[warp] = kmin;
      s_red[8 + warp] = kmax;
    }
  }
  for (int e = tid; e < K3; e += THREADS) s_mask[e] = 0;
  __syncthreads();
  int kmin = s_red[0], kmax = s_red[8];
#pragma unroll
  for (int w = 1; w < TQ / 32; ++w) {
    kmin = min(kmin, s_red[w]);
    kmax = max(kmax, s_red[8 + w]);
  }
  const bool any = kmax >= 0;

  // the window [lo, hi) of source rows that slab dx can reach from the tile
  if (any) {
    for (int s = warp; s < 2 * (slab_end - slab_begin); s += THREADS / 32) {
      const int dx = slab_begin + s / 2 - h;
      const int t = (s & 1) ? kmax + dx * (1 << a.sx) + h * (1 << a.sy) + h + 1
                            : kmin + dx * (1 << a.sx) - h * (1 << a.sy) - h;
      const int pos = warp_lower_bound(gsk, a.N, t, lane);
      if (lane == 0) ((s & 1) ? s_hi : s_lo)[s / 2] = pos;
    }
  }
  __syncthreads();

  for (int dxi = slab_begin; dxi < slab_end; ++dxi) {
    const int lo = s_lo[dxi - slab_begin], hi = s_hi[dxi - slab_begin];
    if (!any || lo >= hi) continue;
    const int W = hi - lo;
    const bool staged = W <= K1_WCAP;
    if (staged) {
      for (int e = tid; e < W; e += THREADS) s_win[e] = gsk[lo + e];
      __syncthreads();
    }
    if (staged)  // two copies: the staged one searches shared memory
      k1_map_slab(a, s_win, W, lo, dxi, o_begin, o_end, s_qkey, s_map, s_mask,
                  tid, lane);
    else
      k1_map_slab(a, gsk + lo, W, lo, dxi, o_begin, o_end, s_qkey, s_map,
                  s_mask, tid, lane);
    __syncthreads();  // the window is restaged for the next slab
  }
}

// 4 x 2 warps, each owning 16 query rows x TN / 2 output columns.
template <int TN, bool BT>
__global__ void __launch_bounds__(K1_THREADS, 2)
    spconv_k1_gemm(const K1Args a) {
  constexpr int TQ = K1_TQ, NI = TN / 16;
  using S = K1Smem<TN, BT>;
  constexpr int NST = S::NST, IT = S::IT;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + S::A;
  const int K = a.K, KK = K * K, K3 = KK * K;
  int* s_map = reinterpret_cast<int*>(sB + S::B);  // [K^2][TQ]
  int* s_mask = s_map + KK * TQ;  // 16-row groups with a neighbour, per offset
  int* s_live = s_mask + K3;
  int* s_info = s_live + K3;
  int* s_win = s_info + K3;
  int* s_qkey = s_win + K1_WCAP;
  int* s_lo = s_qkey + TQ;
  int* s_hi = s_lo + KMAX;
  int* s_red = s_hi + KMAX;  // kmin [0, 8), kmax [8, 16), live count at 15

  const int g = blockIdx.z, q0 = blockIdx.x * TQ;
  const int sp = blockIdx.y % a.split, cg = blockIdx.y / a.split;
  const int o_begin = sp * a.per_split, o_end = min(K3, o_begin + a.per_split);
  const int ntiles = (a.Cout + TN - 1) / TN;
  const int ct_begin = cg * a.col_inner;
  const int ct_end = min(ntiles, ct_begin + a.col_inner);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const __nv_bfloat16* gf = a.fb + (size_t)g * a.N * a.Cp;
  const __nv_bfloat16* gw = a.wb + (size_t)(g % a.Gw) * K3 * a.wr * a.ws;
  float* out = a.out + ((size_t)sp * gridDim.z + g) * a.NQ * a.Cout;

  // ---- the kernel map of the block's offsets, shared by its column tiles --
  k1_block_map(a, g, q0, o_begin, o_end, s_map, s_mask, s_win, s_qkey, s_lo,
               s_hi, s_red, tid, lane, warp);
  if (warp == 0) {  // live offsets of the block's range, in offset order
    int n = 0;
    for (int o0 = o_begin; o0 < o_end; o0 += 32) {
      const int o = o0 + lane;
      const int m = o < o_end ? s_mask[o] : 0;
      const unsigned b = __ballot_sync(FULL, m != 0);
      if (m) {
        const int at = n + __popc(b & ((1u << lane) - 1));
        s_live[at] = o;  // and where the step finds it: plane, dz, rows
        s_info[at] = (o / K) * TQ | (o % K) << 14 | m << 18;
      }
      n += __popc(b);
    }
    if (lane == 0) s_red[15] = n;
  }
  __syncthreads();

  const int nkc = (a.Cp + K1_KC - 1) / K1_KC;
  const int items = s_red[15] * nkc;
  const int steps = (items + IT - 1) / IT;
  float acc[NI][4];
  for (int ct = ct_begin; ct < ct_end; ++ct) {
    const int n0 = ct * TN;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

    // ---- pipelined gather-GEMM over (live offset, channel chunk) items,
    // IT items a step (a stage holds IT A and B tiles) ----
    constexpr int TA = S::A / (NST * IT), TB = S::B / (NST * IT);  // a tile
    int lli = 0, lkc = 0, lit = 0;  // the next item to load: offset, chunk
    auto load_step = [&](int st) {
#pragma unroll
      for (int it = 0; it < IT; ++it, ++lit)
        if (lit < items) {
          k1_load<TN, BT>(a, s_map, s_info[lli], s_live[lli], lkc * K1_KC,
                          n0, gf, gw, K3, sA + (st * IT + it) * TA,
                          sB + (st * IT + it) * TB, tid);
          if (++lkc == nkc) lkc = 0, ++lli;
        }
    };
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
      if (s < steps) load_step(s);
      cp_async_commit();
    }
    int lst = NST - 1, cst = 0;     // stages to load and to compute
    int cli = 0, ckc = 0, cit = 0;  // the item to compute
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // step s has landed; stage (s - 1) is free
      if (s + NST - 1 < steps) {
        load_step(lst);
        lst = lst + 1 == NST ? 0 : lst + 1;
      }
      cp_async_commit();
#pragma unroll
      for (int it = 0; it < IT; ++it, ++cit) {
        if (cit >= items) break;
        // a warp whose 16 rows have no neighbour at this offset skips it
        if ((s_info[cli] >> (18 + wm)) & 1) {
          const __nv_bfloat16* As = sA + (cst * IT + it) * TA;
          const __nv_bfloat16* Bs = sB + (cst * IT + it) * TB;
          switch (min(K1_KC, a.Cp - ckc * K1_KC)) {  // channels left
            case 16: k1_mma<TN, BT, 16>(acc, As, Bs, wm, wn, lane); break;
            case 32: k1_mma<TN, BT, 32>(acc, As, Bs, wm, wn, lane); break;
            case 48: k1_mma<TN, BT, 48>(acc, As, Bs, wm, wn, lane); break;
            default: k1_mma<TN, BT, 64>(acc, As, Bs, wm, wn, lane);
          }
        }
        if (++ckc == nkc) ckc = 0, ++cli;
      }
      cst = cst + 1 == NST ? 0 : cst + 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are rewritten by the next column tile

    // ---- epilogue: f32 tile to out (or to this split's partial) ----
    const bool pair = (a.Cout & 1) == 0;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
          const int q = q0 + wm * 16 + (lane >> 2) + hf * 8;
          const int n = n0 + wn * (TN / 2) + ni * 8 + (lane & 3) * 2;
          if (q >= a.NQ) continue;
          float* dst = out + (size_t)q * a.Cout + n;
          const float v0 = acc[ni][2 * hf], v1 = acc[ni][2 * hf + 1];
          if (pair && n + 1 < a.Cout) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < a.Cout) dst[0] = v0;
            if (n + 1 < a.Cout) dst[1] = v1;
          }
        }
  }
}

// out[i] = sum over splits s = 0, 1, ... (in order) of part[s][i].
__global__ void spconv_k1_reduce(const float* __restrict__ part,
                                 float* __restrict__ out, long long n,
                                 int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < split; ++p) s += part[p * n + i];
    out[i] = s;
  }
}

template <int TN, bool BT>
cudaError_t k1_gemm_launch(const K1Args& a, dim3 grid, cudaStream_t st) {
  using S = K1Smem<TN, BT>;
  static bool opted_in = false;  // the largest shared memory, set once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        spconv_k1_gemm<TN, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::bytes(KMAX));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  spconv_k1_gemm<TN, BT><<<grid, K1_THREADS, S::bytes(a.K), st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K3 -----
//
// K3: the weight gradient of K1.  Replaces the TPU kernel
// cagroup3d_tpu/ops/pallas_conv.py::_dw_kernel (launched by _pallas_dw from
// the custom VJPs of subm_conv_classes_mxu and conv_at_coords_mxu).  Per
// weight group gw and offset o,
//   dW[gw, o] = sum_{g mod Gw == gw} sum_q feats[g, row(key(q) + o)]^T gout[g, q]
// over K1's key-sorted source tables (invalid queries and missing neighbours
// add nothing), bf16 operands, f32 sums, f32 out [Gw, K^3, C, Cout].
//
// What bounds it on Hopper, per main-path form: the head's per-class k9 form
// (G 18, 64 -> 64) by its hit FLOPs (113 GFLOP, 0.11 ms at the bf16 peak)
// with the 215 MB of dW it writes close behind; every other form by bytes
// (the tables read once and dW written once: tens of µs).  What stood
// between the first design and those bounds was repeated work: every
// (C tile, Cout tile) block searched the whole source table once per
// (query, offset), and multiplied 64-query steps that were mostly empty.
// Design:
//   * k3_prep, one launch: the packed keys of both tables, bf16 feats (invalid
//     rows zeroed, channels padded to a multiple of 16, so C = 3 takes the
//     tensor-core path) and the bf16 cotangent (invalid query rows zeroed,
//     columns padded to a multiple of 8);
//   * the map, built once per call and shared by every dW tile: k3_map builds
//     K1's in-block map for each 64-query tile (k1_block_map: one search per
//     (dx, dy) plane in a staged window of sorted source keys, a dz scan) and
//     writes its entries and its hit count per offset; k3_scan turns the
//     counts into each tile's place in the (group, offset) pair list; k3_fill
//     writes the pairs (source row, query), ascending in query.  The lists
//     hold misses nowhere, so every pipeline stage below is dense.  Scratch is
//     sized for the worst case, G K^3 NQ pairs of 8 bytes (430 MB at the k9
//     form), with no host sync;
//   * k3_gemm: a block (one warpgroup) owns (group, offset, 64-row C tile,
//     64- or 128-column Cout tile, pair split).  A ring of three cp.async
//     stages gathers 64 pairs' feats rows and gout rows into 128-byte swizzled
//     tiles while the tensor cores multiply the previous stage: wgmma
//     m64nNk16 with both operands read transposed (MN-major) from shared
//     memory, f32 accumulators in registers (mma.sync m16n8k16 on the same
//     tiles was as fast or slower at every main-path form).  k3_plan
//     (ops/sparse_conv.py) picks the tile width and the splits so that the
//     grid fills two waves of the card's SMs;
//   * with one split and one group per weight group the block writes dW
//     directly; otherwise k3_reduce sums the partial tiles in a fixed order
//     (groups ascending, then splits).  No float atomics anywhere: two calls
//     give the same bits.

constexpr int K3_KP = 64;        // pairs per pipeline stage
constexpr int K3_TC = 64;        // dW rows (input channels) per block
constexpr int K3_THREADS = 128;  // one warpgroup
constexpr int K3_NSTAGE = 3;

// One block per (64-query tile, group): the tile's map entries [K^2][64]
// (planes of slabs without a window stay 0: no hit) and its hit count per
// offset, cnt[g][o][tile].
__global__ void __launch_bounds__(K1_THREADS)
    spconv_k3_map(const K1Args a, int* __restrict__ gmap,
                  int* __restrict__ cnt, int T) {
  constexpr int TQ = K1_TQ;
  __shared__ int s_map[KMAX * KMAX * TQ];
  __shared__ int s_mask[KMAX * KMAX * KMAX];
  __shared__ int s_win[K1_WCAP];
  __shared__ int s_qkey[TQ];
  __shared__ int s_lo[KMAX], s_hi[KMAX], s_red[16];
  const int t = blockIdx.x, g = blockIdx.y;
  const int K = a.K, KK = K * K, K3 = KK * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < KK * TQ; e += K1_THREADS) s_map[e] = 0;
  k1_block_map(a, g, t * TQ, 0, K3, s_map, s_mask, s_win, s_qkey, s_lo, s_hi,
               s_red, tid, lane, warp);
  int* gm = gmap + ((size_t)g * T + t) * KK * TQ;
  for (int e = tid; e < KK * TQ; e += K1_THREADS) gm[e] = s_map[e];
  for (int o = warp; o < K3; o += K1_THREADS / 32) {
    int c = 0;
    if (s_mask[o]) {
      const int p = o / K, dz = o - p * K;
      c = __popc(__ballot_sync(FULL, (s_map[p * TQ + lane] >> dz) & 1)) +
          __popc(__ballot_sync(FULL, (s_map[p * TQ + 32 + lane] >> dz) & 1));
    }
    if (lane == 0) cnt[((size_t)g * K3 + o) * T + t] = c;
  }
}

// One block per (group, offset) list: the exclusive prefix of its tiles'
// counts, in place, and the list's length.
__global__ void __launch_bounds__(128)
    spconv_k3_scan(int* __restrict__ cnt, int* __restrict__ lens, int T) {
  __shared__ int s_w[4];
  int* c = cnt + (size_t)blockIdx.x * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < T; base += 128 * 4) {
    int v[4], sum = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + tid * 4 + u;
      v[u] = i < T ? c[i] : 0;
      sum += v[u];
    }
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) s_w[warp] = inc;
    __syncthreads();
    int run = carry + inc - sum, tot = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      run += w < warp ? s_w[w] : 0;
      tot += s_w[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + tid * 4 + u;
      if (i < T) c[i] = run;
      run += v[u];
    }
    carry += tot;
    __syncthreads();
  }
  if (tid == 0) lens[blockIdx.x] = carry;
}

// One block per (64-query tile, group): the tile's pairs (source row, query)
// of every offset, at the tile's place in the offset's list, ascending in
// query.  A warp takes a (dx, dy) plane: two entries a lane, one ballot per
// dz and half tile.
__global__ void __launch_bounds__(256)
    spconv_k3_fill(const int* __restrict__ gmap, const int* __restrict__ cnt,
                   int2* __restrict__ pairs, int NQ, int K, int T) {
  constexpr int TQ = K1_TQ;
  const int t = blockIdx.x, g = blockIdx.y, KK = K * K, K3 = KK * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int* gm = gmap + ((size_t)g * T + t) * KK * TQ;
  for (int p = warp; p < KK; p += 8) {
    const int e0 = gm[p * TQ + lane], e1 = gm[p * TQ + 32 + lane];
    for (int dz = 0; dz < K; ++dz) {
      const bool h0 = (e0 >> dz) & 1, h1 = (e1 >> dz) & 1;
      const unsigned b0 = __ballot_sync(FULL, h0), b1 = __ballot_sync(FULL, h1);
      if (!(b0 | b1)) continue;
      const size_t list = (size_t)g * K3 + p * K + dz;
      int2* dst = pairs + list * NQ + cnt[list * T + t];
      const unsigned below = (1u << dz) - 1;
      if (h0)
        dst[__popc(b0 & lt)] =
            make_int2((e0 >> 9) + __popc(e0 & below), t * TQ + lane);
      if (h1)
        dst[__popc(b0) + __popc(b1 & lt)] =
            make_int2((e1 >> 9) + __popc(e1 & below), t * TQ + 32 + lane);
    }
  }
}

// One launch of operand preparation: source (and query) keys, bf16 feats
// [G, N, Cp] with invalid rows zeroed, bf16 cotangent [G, NQ, Coutp] with
// invalid query rows zeroed; rows go 8 values (one 16-byte store) per item.
__global__ void spconv_k3_prep(const int* __restrict__ slat,
                               const uint8_t* __restrict__ svalid,
                               const float* __restrict__ feats,
                               const int* __restrict__ qlat,
                               const uint8_t* __restrict__ qvalid,
                               const float* __restrict__ gout, int* sk,
                               int* qk, __nv_bfloat16* fb, __nv_bfloat16* gb,
                               int nsrc, int nqry, int nrow, int C, int Cp,
                               int Cout, int Coutp, int margin, int sx,
                               int sy, int ex, int ey, int ez) {
  const int fg = Cp / 8, gg = Coutp / 8;
  const int nf = nsrc * fg, total = nsrc + nqry + nf + nrow * gg;
  const bool fvec = C % 4 == 0, gvec = Cout % 4 == 0;
  const uint8_t* rvalid = qvalid ? qvalid : svalid;  // the cotangent's rows
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int j = i;
    if (j < nsrc) {
      sk[j] = pack_key(slat + 3 * j, svalid[j], margin, sx, sy, ex, ey, ez);
    } else if ((j -= nsrc) < nqry) {
      qk[j] = pack_key(qlat + 3 * j, qvalid[j], margin, sx, sy, ex, ey, ez);
    } else if ((j -= nqry) < nf) {
      const int r = j / fg, c0 = (j - r * fg) * 8;
      *reinterpret_cast<uint4*>(fb + (size_t)r * Cp + c0) =
          bf16x8(feats + (size_t)r * C, c0, C, svalid[r], fvec);
    } else {
      j -= nf;
      const int r = j / gg, n0 = (j - r * gg) * 8;
      *reinterpret_cast<uint4*>(gb + (size_t)r * Coutp + n0) =
          bf16x8(gout + (size_t)r * Cout, n0, Cout, rvalid[r], gvec);
    }
  }
}

struct K3Args {
  const __nv_bfloat16* fb;  // [G, N, Cp]
  const __nv_bfloat16* gb;  // [G, NQ, Coutp]
  const int2* pairs;        // [G * K^3][NQ]: (source row, query)
  const int* lens;          // [G * K^3] pairs of each list
  float* out;               // [split][G * K^3][C][Cout], or dW when direct
  int N, NQ, C, Cp, Cout, Coutp, K3, ntiles, split;
};

// A stage's tiles: A [K3_KP pairs][64 channels] and B [K3_KP pairs][TN
// columns] as TN / 64 sub-tiles of [K3_KP][64]; 128-byte rows whose 16-byte
// chunk c sits at chunk c ^ (row & 7), the 128-byte swizzle of wgmma.
template <int TN>
struct K3Smem {
  static constexpr int A = K3_KP * K3_TC, B = K3_KP * TN;  // bf16 elements
  static constexpr int bytes = 2 * K3_NSTAGE * (A + B) + 1024;  // + alignment
};

__device__ __forceinline__ int k3_swz(int row, int chunk) {
  return row * 64 + ((chunk ^ (row & 7)) << 3);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand read
// MN-major: 8-row groups 1024 bytes apart (SBO), 64-column sub-tiles
// K3_KP * 128 bytes apart (LBO).
__device__ __forceinline__ uint64_t k3_desc(const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((s & 0x3ffff) >> 4) |
         (uint64_t)(K3_KP * 128 >> 4) << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// acc[c, n] += sum over the stage's pairs p of A[p, c] B[p, n], four k16
// steps of wgmma m64nNk16: warp w of the warpgroup holds dW rows
// [16 w, 16 w + 16), acc[j] columns [8 j, 8 j + 8).
template <int TN>
__device__ __forceinline__ void k3_mma(float (&acc)[TN / 8][4],
                                       const __nv_bfloat16* As,
                                       const __nv_bfloat16* Bs) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < K3_KP / 16; ++ks) {
    const uint64_t da = k3_desc(As + ks * 16 * 64);
    const uint64_t db = k3_desc(Bs + ks * 16 * 64);
    if constexpr (TN == 64) wgmma_n64(acc, da, db);
    else wgmma_n128(acc, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Grid (C tile x Cout tile, split, group x offset).
template <int TN>
__global__ void __launch_bounds__(K3_THREADS)
    spconv_k3_gemm(const K3Args a) {
  using S = K3Smem<TN>;
  constexpr int NST = K3_NSTAGE, BSUB = TN / 64;
  extern __shared__ unsigned char k3_smem[];
  const unsigned s0 = (unsigned)__cvta_generic_to_shared(k3_smem);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      k3_smem + (((s0 + 1023) & ~1023u) - s0));  // swizzle atoms: 1024-aligned
  __nv_bfloat16* sB = sA + NST * S::A;
  const int go = blockIdx.z, sp = blockIdx.y;
  const int g = go / a.K3;
  const int ct = blockIdx.x / a.ntiles, nt = blockIdx.x - ct * a.ntiles;
  const int c0 = ct * K3_TC, n0 = nt * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the block's pairs: split sp of the (g, o) list
  const int n = a.lens[go], per = (n + a.split - 1) / a.split;
  const int p0 = min(n, sp * per), np = min(n, p0 + per) - p0;
  const int2* list = a.pairs + (size_t)go * a.NQ + p0;
  const __nv_bfloat16* gf = a.fb + (size_t)g * a.N * a.Cp;
  const __nv_bfloat16* gg = a.gb + (size_t)g * a.NQ * a.Coutp;

  // each thread copies 16-byte chunk `seg` of rows rbase + 16 j of A and of
  // every B sub-tile; its swizzled chunk is the same in all of them
  const int seg = tid & 7, rbase = tid >> 3;
  const int sw = k3_swz(rbase, seg), ca = c0 + seg * 8;
  const bool a_ok = ca < a.Cp;
  int2 pf[K3_KP / 16];  // the pairs of the next step to load
  auto fetch = [&](int step) {
#pragma unroll
    for (int j = 0; j < K3_KP / 16; ++j) {
      const int p = step * K3_KP + rbase + 16 * j;
      pf[j] = p < np ? list[p] : make_int2(-1, 0);
    }
  };
  auto issue = [&](int st) {
    __nv_bfloat16* As = sA + st * S::A + sw;
    __nv_bfloat16* Bs = sB + st * S::B + sw;
#pragma unroll
    for (int j = 0; j < K3_KP / 16; ++j) {
      const bool ok = pf[j].x >= 0, oka = ok && a_ok;
      cp_async16(As + j * 16 * 64,
                 oka ? gf + ((size_t)pf[j].x * a.Cp + ca) : gf, oka ? 16 : 0);
#pragma unroll
      for (int h = 0; h < BSUB; ++h) {
        const int nn = n0 + h * 64 + seg * 8;
        const bool okb = ok && nn < a.Coutp;
        cp_async16(Bs + h * K3_KP * 64 + j * 16 * 64,
                   okb ? gg + ((size_t)pf[j].y * a.Coutp + nn) : gg,
                   okb ? 16 : 0);
      }
    }
  };

  float acc[TN / 8][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int steps = (np + K3_KP - 1) / K3_KP;
  fetch(0);
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) {
      issue(s);
      fetch(s + 1);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NST - 2>();
    // the copies are read by the async proxy (wgmma)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step s has landed; stage (s - 1) is free
    if (s + NST - 1 < steps) {
      issue((s + NST - 1) % NST);
      fetch(s + NST);
    }
    cp_async_commit();
    const int st = s % NST;
    k3_mma<TN>(acc, sA + st * S::A, sB + st * S::B);
  }
  cp_async_wait<0>();

  // ---- epilogue: the f32 tile to dW (direct) or to this split's partial --
  float* dst = a.out + ((size_t)sp * gridDim.z + go) * a.C * a.Cout;
  const bool pair = (a.Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + warp * 16 + (lane >> 2) + hf * 8;
      const int nn = n0 + j * 8 + (lane & 3) * 2;
      if (c >= a.C) continue;
      float* d = dst + (size_t)c * a.Cout + nn;
      const float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
      if (pair && nn + 1 < a.Cout) {
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      } else {
        if (nn < a.Cout) d[0] = v0;
        if (nn + 1 < a.Cout) d[1] = v1;
      }
    }
}

// dW[gw, e] = sum over groups g = gw, gw + Gw, ... (ascending) and then
// splits (ascending) of the partial tiles: a fixed order.
__global__ void spconv_k3_reduce(const float* __restrict__ part,
                                 float* __restrict__ out, long long per_group,
                                 int G, int Gw, int split) {
  const long long n = (long long)Gw * per_group;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int gw = (int)(i / per_group);
    const long long e = i - gw * per_group;
    float s = 0.f;
    for (int g = gw; g < G; g += Gw)
      for (int p = 0; p < split; ++p)
        s += part[((long long)p * G + g) * per_group + e];
    out[i] = s;
  }
}

template <int TN>
cudaError_t k3_gemm_launch(const K3Args& a, dim3 grid, cudaStream_t st) {
  using S = K3Smem<TN>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        spconv_k3_gemm<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  spconv_k3_gemm<TN><<<grid, K3_THREADS, S::bytes, st>>>(a);
  return cudaGetLastError();
}
}  // namespace

// K1: prep, gemm and (split > 1) reduce on one stream.  The plan (tn,
// col_inner, split, per_split) comes from the wrapper's table
// (ops/sparse_conv.py::k1_plan); rev != 0 runs the feature backward,
// whose weights w are the forward's [Gw, K^3, Cout, C] read offset-reversed.
extern "C" int spconv_k1_launch(
    const void* slat, const void* svalid, const void* feats, const void* qlat,
    const void* qvalid, const void* w, void* sk, void* qk, void* fb, void* wb,
    void* part, void* out, int G, int N, int NQ, int C, int Cout, int Gw,
    int K, int rev, int tn, int col_inner, int split, int per_split,
    int margin, int sx, int sy, int ex, int ey, int ez, void* stream) {
  const int K3 = K * K * K;
  if (K > KMAX || K % 2 == 0 || Gw <= 0 || G % Gw != 0 ||
      (tn != 64 && tn != 128) || col_inner < 1 ||
      split < 1 || per_split < 1 || (long long)split * per_split < K3 ||
      (long long)(split - 1) * per_split >= K3 || N >= (1 << 22))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || NQ == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int Cp = (C + 15) / 16 * 16, Coutp = (Cout + 7) / 8 * 8;
  const int R = rev ? Cout : C, S = rev ? C : Cout;
  const int Rp = rev ? Coutp : Cp, Sp = rev ? Cp : Coutp;
  const long long nsrc = (long long)G * N, nqry = qlat ? (long long)G * NQ : 0;
  const long long work =
      nsrc + nqry + nsrc * Cp / 8 + (long long)Gw * K3 * Rp * Sp / 8;
  if (work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256
                                                          : 132 * 16);
  spconv_k1_prep<<<blocks, 256, 0, st>>>(
      (const int*)slat, (const uint8_t*)svalid, (const float*)feats,
      (const int*)qlat, (const uint8_t*)qvalid, (const float*)w, (int*)sk,
      (int*)qk, (__nv_bfloat16*)fb, (__nv_bfloat16*)wb, (int)nsrc, (int)nqry,
      C, Cp, Gw * K3, R, S, Rp, Sp, margin, sx, sy, ex, ey, ez);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  K1Args a;
  a.sk = (const int*)sk;
  a.qk = qlat ? (const int*)qk : (const int*)sk;
  a.fb = (const __nv_bfloat16*)fb;
  a.wb = (const __nv_bfloat16*)wb;
  a.out = (float*)(split > 1 ? part : out);
  a.N = N; a.NQ = NQ; a.Cp = Cp; a.Cout = Cout; a.Gw = Gw; a.K = K;
  a.wr = Rp; a.ws = Sp;
  a.col_inner = col_inner; a.split = split; a.per_split = per_split;
  a.sx = sx; a.sy = sy; a.ex = ex; a.ey = ey; a.ez = ez;
  const int ntiles = (Cout + tn - 1) / tn;
  const dim3 grid((NQ + K1_TQ - 1) / K1_TQ,
                  (ntiles + col_inner - 1) / col_inner * split, G);
  if (tn == 64)
    err = rev ? k1_gemm_launch<64, true>(a, grid, st)
              : k1_gemm_launch<64, false>(a, grid, st);
  else
    err = rev ? k1_gemm_launch<128, true>(a, grid, st)
              : k1_gemm_launch<128, false>(a, grid, st);
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long n = (long long)G * NQ * Cout;
  const int rb = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8);
  spconv_k1_reduce<<<rb, 256, 0, st>>>((const float*)part, (float*)out, n,
                                       split);
  return (int)cudaGetLastError();
}

// K3: prep, map, scan, fill, gemm and (unless direct) reduce on one stream.
// The plan (tn, split) comes from the wrapper's table
// (ops/sparse_conv.py::k3_plan); the scratch pointers from its layout
// (_k3_scratch).
extern "C" int spconv_k3_launch(
    const void* slat, const void* svalid, const void* feats, const void* qlat,
    const void* qvalid, const void* gout, void* sk, void* qk, void* fb,
    void* gb, void* gmap, void* cnt, void* lens, void* pairs, void* part,
    void* out, int G, int N, int NQ, int C, int Cout, int Gw, int K, int tn,
    int split, int margin, int sx, int sy, int ex, int ey, int ez,
    void* stream) {
  const int K3 = K * K * K;
  if (K > KMAX || K % 2 == 0 || Gw <= 0 || G % Gw != 0 ||
      (tn != 64 && tn != 128) || split < 1 || split > 65535 ||
      N >= (1 << 22) || (long long)G * K3 > 65535)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long per_group = (long long)K3 * C * Cout;
  if (NQ == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * Gw * per_group, st);
  const int Cp = (C + 15) / 16 * 16, Coutp = (Cout + 7) / 8 * 8;
  const int T = (NQ + K1_TQ - 1) / K1_TQ;
  const long long nsrc = (long long)G * N, nqry = qlat ? (long long)G * NQ : 0;
  const long long work =
      nsrc + nqry + nsrc * Cp / 8 + (long long)G * NQ * Coutp / 8;
  if (work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256
                                                          : 132 * 16);
  spconv_k3_prep<<<blocks, 256, 0, st>>>(
      (const int*)slat, (const uint8_t*)svalid, (const float*)feats,
      (const int*)qlat, (const uint8_t*)qvalid, (const float*)gout, (int*)sk,
      (int*)qk, (__nv_bfloat16*)fb, (__nv_bfloat16*)gb, (int)nsrc, (int)nqry,
      G * NQ, C, Cp, Cout, Coutp, margin, sx, sy, ex, ey, ez);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  K1Args m = {};
  m.sk = (const int*)sk;
  m.qk = qlat ? (const int*)qk : (const int*)sk;
  m.N = N; m.NQ = NQ; m.K = K;
  m.sx = sx; m.sy = sy; m.ex = ex; m.ey = ey; m.ez = ez;
  spconv_k3_map<<<dim3(T, G), K1_THREADS, 0, st>>>(m, (int*)gmap, (int*)cnt,
                                                   T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  spconv_k3_scan<<<G * K3, 128, 0, st>>>((int*)cnt, (int*)lens, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  spconv_k3_fill<<<dim3(T, G), 256, 0, st>>>((const int*)gmap,
                                             (const int*)cnt, (int2*)pairs,
                                             NQ, K, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const bool direct = split == 1 && G == Gw;
  K3Args a;
  a.fb = (const __nv_bfloat16*)fb;
  a.gb = (const __nv_bfloat16*)gb;
  a.pairs = (const int2*)pairs;
  a.lens = (const int*)lens;
  a.out = (float*)(direct ? out : part);
  a.N = N; a.NQ = NQ; a.C = C; a.Cp = Cp; a.Cout = Cout; a.Coutp = Coutp;
  a.K3 = K3; a.ntiles = (Cout + tn - 1) / tn; a.split = split;
  const dim3 grid((Cp + K3_TC - 1) / K3_TC * a.ntiles, split, G * K3);
  err = tn == 64 ? k3_gemm_launch<64>(a, grid, st)
                 : k3_gemm_launch<128>(a, grid, st);
  if (err != cudaSuccess || direct) return (int)err;
  const long long n = (long long)Gw * per_group;
  const int rb = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8);
  spconv_k3_reduce<<<rb, 256, 0, st>>>((const float*)part, (float*)out,
                                       per_group, G, Gw, split);
  return (int)cudaGetLastError();
}
