// Native greedy-matching kernel for the official KITTI eval protocol.
//
// Mirrors cagroup3d_tpu_torch/datasets/kitti_eval.py:compute_statistics_py
// (itself a rebuild of the reference numba kernel, pcdet/datasets/kitti/
// kitti_object_eval_python/eval.py:158-338 compute_statistics_jit +
// fused_compute_statistics).  The matching is inherently sequential per
// frame (first-come greedy assignment in GT order), so it runs on the
// host; frames x thresholds parallelize over OpenMP threads.
//
// Layout (all row-major, frame-concatenated):
//   overlaps: per frame [n_dt, n_gt] flattened then concatenated
//   gt_datas: [sum_gt, 5]  (bbox x1 y1 x2 y2, alpha)
//   dt_datas: [sum_dt, 6]  (bbox x1 y1 x2 y2, alpha, score)
//   dc_boxes: [sum_dc, 4]
//   pr:       [n_thresh, 4] accumulated (tp, fp, fn, similarity)
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kNoDetection = -10000000.0;

inline double image_overlap_crit0(const double *a, const double *b) {
  // inter / area(a) (reference image_box_overlap criterion=0)
  double iw = (a[2] < b[2] ? a[2] : b[2]) - (a[0] > b[0] ? a[0] : b[0]);
  if (iw <= 0) return 0.0;
  double ih = (a[3] < b[3] ? a[3] : b[3]) - (a[1] > b[1] ? a[1] : b[1]);
  if (ih <= 0) return 0.0;
  double area = (a[2] - a[0]) * (a[3] - a[1]);
  return iw * ih / area;
}

struct Stats {
  int tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
};

Stats one_frame(const double *ov, int n_gt, int n_dt, const double *gt,
                const double *dt, const double *dc, int n_dc,
                const int32_t *ig, const int32_t *idt, int metric,
                double min_overlap, double thresh, bool compute_aos) {
  Stats s;
  std::vector<uint8_t> assigned(n_dt, 0), ign_thr(n_dt, 0);
  for (int j = 0; j < n_dt; ++j)
    if (dt[j * 6 + 5] < thresh) ign_thr[j] = 1;
  std::vector<double> delta;
  for (int i = 0; i < n_gt; ++i) {
    if (ig[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int j = 0; j < n_dt; ++j) {
      if (idt[j] == -1 || assigned[j] || ign_thr[j]) continue;
      double overlap = ov[j * n_gt + i];
      if (overlap > min_overlap &&
          (overlap > max_overlap || assigned_ignored_det) && idt[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (overlap > min_overlap && valid_detection == kNoDetection &&
                 idt[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == kNoDetection && ig[i] == 0) {
      s.fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ig[i] == 1 || idt[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      s.tp += 1;
      if (compute_aos) delta.push_back(gt[i * 5 + 4] - dt[det_idx * 6 + 4]);
      assigned[det_idx] = 1;
    }
  }
  for (int j = 0; j < n_dt; ++j)
    if (!(assigned[j] || idt[j] == -1 || idt[j] == 1 || ign_thr[j]))
      s.fp += 1;
  if (metric == 0 && n_dc > 0) {
    int nstuff = 0;
    for (int i = 0; i < n_dc; ++i)
      for (int j = 0; j < n_dt; ++j) {
        if (assigned[j] || idt[j] == -1 || idt[j] == 1 || ign_thr[j])
          continue;
        if (image_overlap_crit0(dt + j * 6, dc + i * 4) > min_overlap) {
          assigned[j] = 1;
          nstuff += 1;
        }
      }
    s.fp -= nstuff;
  }
  if (compute_aos) {
    double sum = 0.0;
    for (double d : delta) sum += (1.0 + std::cos(d)) / 2.0;
    s.similarity = (s.tp > 0 || s.fp > 0) ? sum : -1.0;
  }
  return s;
}

}  // namespace

extern "C" void kitti_stats_batch(
    const double *overlaps, const int32_t *gt_nums, const int32_t *dt_nums,
    const int32_t *dc_nums, int n_frames, const double *gt_datas,
    const double *dt_datas, const double *dc_boxes, const int32_t *ig,
    const int32_t *idt, int metric, double min_overlap,
    const double *thresholds, int n_thresh, int compute_aos, double *pr) {
  // frame offsets
  std::vector<int64_t> ov_off(n_frames + 1, 0), gt_off(n_frames + 1, 0),
      dt_off(n_frames + 1, 0), dc_off(n_frames + 1, 0);
  for (int f = 0; f < n_frames; ++f) {
    ov_off[f + 1] = ov_off[f] + (int64_t)gt_nums[f] * dt_nums[f];
    gt_off[f + 1] = gt_off[f] + gt_nums[f];
    dt_off[f + 1] = dt_off[f] + dt_nums[f];
    dc_off[f + 1] = dc_off[f] + dc_nums[f];
  }
  std::memset(pr, 0, sizeof(double) * n_thresh * 4);
#pragma omp parallel for schedule(dynamic)
  for (int t = 0; t < n_thresh; ++t) {
    for (int f = 0; f < n_frames; ++f) {
      Stats s = one_frame(
          overlaps + ov_off[f], gt_nums[f], dt_nums[f],
          gt_datas + gt_off[f] * 5, dt_datas + dt_off[f] * 6,
          dc_boxes + dc_off[f] * 4, dc_nums[f], ig + gt_off[f],
          idt + dt_off[f], metric, min_overlap, thresholds[t],
          compute_aos != 0);
      pr[t * 4 + 0] += s.tp;
      pr[t * 4 + 1] += s.fp;
      pr[t * 4 + 2] += s.fn;
      if (s.similarity != -1.0) pr[t * 4 + 3] += s.similarity;
    }
  }
}
