// K2: sorted-run segment sums for the dense head's per-class fine maps.
//
// Replaces the TPU kernel cagroup3d_tpu/ops/pallas_segsum.py::_segsum_kernel.
// Per group g, over key-sorted rows (INVALID_KEY last): sums[g, j, :] is the
// f32 sum of the bf16 feature rows of the j-th run of equal keys and
// counts[g, j] its row count, for runs j < cap.
//
// What bounds it on Hopper: bytes.  Each row is read once (2F bytes), and
// under capacity overflow (the normal case at full caps) the walk stops as
// soon as run `cap` has started, so most rows are never read.  Design: one
// block per group walks the rows in chunks of CH; a block-wide scan of the
// run-head flags, offset by the runs completed before the chunk (`base`,
// carried in a register), gives each row its run id exactly; each warp then
// reduces 32 consecutive rows with its lanes across the features, keeping
// the current run's partial sum in registers and flushing it with one
// atomicAdd per (run, feature) when the run id changes.  Counts are exact
// integers; sums are f32 in a row order that varies only at warp borders.
// Simple before fast: G blocks only (18 at head shapes), so the card is far
// from full; a multi-block split per group is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int INVALID_KEY = (1 << 30) + 1;
constexpr int CH = 256;            // rows per chunk == threads per block
constexpr int NWARP = CH / 32;
constexpr int MAX_F_PER_LANE = 8;  // F <= 256

__global__ void __launch_bounds__(CH)
segsum_kernel(const int* __restrict__ sk, const __nv_bfloat16* __restrict__ feats,
              float* __restrict__ sums, int* __restrict__ counts, int P, int F,
              int cap) {
  const int g = blockIdx.x;
  const int* keys = sk + (size_t)g * P;
  const __nv_bfloat16* rows = feats + (size_t)g * P * F;
  float* gsum = sums + (size_t)g * cap * F;
  int* gcnt = counts + (size_t)g * cap;

  __shared__ int s_uid[CH];
  __shared__ int s_warp[NWARP];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nf = (F + 31) / 32;

  int base = 0;  // runs started before this chunk (block-uniform)
  for (int c0 = 0; c0 < P; c0 += CH) {
    const int i = c0 + t;
    const int key = i < P ? keys[i] : INVALID_KEY;
    const int prev = (i > 0 && i < P) ? keys[i - 1] : -1;
    const bool valid = key != INVALID_KEY;
    int x = (valid && key != prev) ? 1 : 0;

    // inclusive block scan of the run-head flags
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < NWARP ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < NWARP) s_warp[lane] = w;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? s_warp[warp - 1] : 0);
    const int uid = base + incl - 1;
    s_uid[t] = (valid && uid < cap) ? uid : -1;
    const int total = s_warp[NWARP - 1];
    __syncthreads();

    // warp `warp` reduces rows [32*warp, 32*warp + 32) of the chunk
    float acc[MAX_F_PER_LANE];
#pragma unroll
    for (int j = 0; j < MAX_F_PER_LANE; ++j) acc[j] = 0.f;
    int cur = -1, cnt = 0;
    for (int r = 0; r < 32; ++r) {
      const int u = s_uid[warp * 32 + r];
      if (u != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int j = 0; j < MAX_F_PER_LANE; ++j) {
            const int f = lane + 32 * j;
            if (j < nf && f < F) atomicAdd(&gsum[(size_t)cur * F + f], acc[j]);
            acc[j] = 0.f;
          }
          if (lane == 0) atomicAdd(&gcnt[cur], cnt);
        }
        cur = u;
        cnt = 0;
      }
      if (u >= 0) {
        const __nv_bfloat16* row = rows + (size_t)(c0 + warp * 32 + r) * F;
#pragma unroll
        for (int j = 0; j < MAX_F_PER_LANE; ++j) {
          const int f = lane + 32 * j;
          if (j < nf && f < F) acc[j] += __bfloat162float(row[f]);
        }
        ++cnt;
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int j = 0; j < MAX_F_PER_LANE; ++j) {
        const int f = lane + 32 * j;
        if (j < nf && f < F) atomicAdd(&gsum[(size_t)cur * F + f], acc[j]);
      }
      if (lane == 0) atomicAdd(&gcnt[cur], cnt);
    }

    base += total;
    const int last = c0 + CH - 1;
    // early exit: run `cap` has started (runs 0..cap-1 are complete), or
    // the chunk ended in invalid rows (sorted last: nothing valid follows)
    const bool stop = base >= cap + 1 || last >= P - 1 ||
                      keys[last] == INVALID_KEY;
    __syncthreads();  // s_uid / s_warp are rewritten by the next chunk
    if (stop) break;
  }
}

}  // namespace

extern "C" int segsum_launch(const void* sk, const void* feats, void* sums,
                             void* counts, int G, int P, int F, int cap,
                             void* stream) {
  segsum_kernel<<<G, CH, 0, (cudaStream_t)stream>>>(
      (const int*)sk, (const __nv_bfloat16*)feats, (float*)sums, (int*)counts,
      P, F, cap);
  return (int)cudaGetLastError();
}
