// Greedy detection<->GT matcher for COCO-protocol evaluation.
//
// The per-(image, category, IoU-threshold) greedy matching loop of the
// reference (cubercnn/evaluation/omni3d_evaluation.py:1489-1524), the
// host-side hot loop of evaluation once the IoUs are computed. Plain C ABI
// for ctypes (evaluation/native.py); `native.greedy_match_plain` is the
// same loop in Python.
//
// Semantics (exactly the COCO protocol):
//   for each threshold t, for each detection d in score order:
//     pick the unmatched gt with the highest IoU >= t, preferring non-ignored
//     gts (stop scanning once a real match exists and the scan reaches the
//     ignored tail — gts are pre-sorted ignore-last); proximity-gated pairs
//     are skipped entirely.

#include <cstdint>

extern "C" {

// ious:      D*G row-major
// in_prox:   D*G row-major (may be null when use_prox == 0)
// gt_ignore: G
// dt_ids/gt_ids: 1-based ids used for the match matrices
// outputs: dtm, gtm (T*D / T*G, doubles, 0 = unmatched), dt_ig (T*D)
void greedy_match(const float* ious, int D, int G,
                  const double* iou_thrs, int T,
                  const uint8_t* gt_ignore,
                  const uint8_t* in_prox, int use_prox,
                  const int64_t* dt_ids, const int64_t* gt_ids,
                  double* dtm, double* gtm, uint8_t* dt_ig) {
  for (int t = 0; t < T; ++t) {
    double* dtm_t = dtm + (int64_t)t * D;
    double* gtm_t = gtm + (int64_t)t * G;
    uint8_t* dtig_t = dt_ig + (int64_t)t * D;
    for (int d = 0; d < D; ++d) {
      double thr = iou_thrs[t] < 1.0 - 1e-10 ? iou_thrs[t] : 1.0 - 1e-10;
      double best = thr;
      int m = -1;
      const float* iou_row = ious + (int64_t)d * G;
      const uint8_t* prox_row = use_prox ? in_prox + (int64_t)d * G : nullptr;
      for (int g = 0; g < G; ++g) {
        if (use_prox && !prox_row[g]) continue;
        if (gtm_t[g] > 0) continue;
        if (m > -1 && gt_ignore[m] == 0 && gt_ignore[g] == 1) break;
        if ((double)iou_row[g] < best) continue;
        best = (double)iou_row[g];
        m = g;
      }
      if (m == -1) continue;
      dtig_t[d] = gt_ignore[m];
      dtm_t[d] = (double)gt_ids[m];
      gtm_t[m] = (double)dt_ids[d];
    }
  }
}

}  // extern "C"
