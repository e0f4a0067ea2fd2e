// K1: sparse convolution as an output-stationary gather-GEMM with the kernel
// map built in the kernel.
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

}  // namespace

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
