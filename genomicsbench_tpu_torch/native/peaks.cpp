// The scrappie peak detector of f5c's event detection (events.c:370-443):
// the coupled short/long t-statistic state machine, sequential by nature,
// so host code.  The port's own copy of gb_peak_detector
// (genomicsbench_tpu/native/gbingest.cpp:1471-1520), with the same float32
// compares; it has no multiply-add, so the compiler's contraction cannot
// change it.

#include <cstdint>

extern "C" int64_t gb_peak_detector(const float* t1, const float* t2, int64_t n,
                                    int32_t w1, int32_t w2, float th1, float th2,
                                    float peak_height, int64_t* out, int64_t out_cap) {
  const float* sig[2] = {t1, t2};
  const float th[2] = {th1, th2};
  const int32_t wl[2] = {w1, w2};
  const float kFltMax = 3.402823466e+38f;
  int64_t masked_to[2] = {0, 0};
  int64_t peak_pos[2] = {-1, -1};
  float peak_value[2] = {kFltMax, kFltMax};
  bool valid_peak[2] = {false, false};
  int64_t n_out = 0;
  for (int64_t i = 0; i < n; i++) {
    for (int k = 0; k < 2; k++) {
      if (masked_to[k] >= i) continue;  // skips i == 0 too (masked_to starts at 0)
      const float cur = sig[k][i];
      if (peak_pos[k] == -1) {
        if (cur < peak_value[k]) {
          peak_value[k] = cur;
        } else if (cur - peak_value[k] > peak_height) {
          peak_value[k] = cur;
          peak_pos[k] = i;
        }
      } else {
        if (cur > peak_value[k]) {
          peak_value[k] = cur;
          peak_pos[k] = i;
        }
        if (k == 0 && peak_value[0] > th[0]) {
          masked_to[1] = peak_pos[0] + wl[0];
          peak_pos[1] = -1;
          peak_value[1] = kFltMax;
          valid_peak[1] = false;
        }
        if (peak_value[k] - cur > peak_height && peak_value[k] > th[k]) valid_peak[k] = true;
        if (valid_peak[k] && (i - peak_pos[k]) > wl[k] / 2) {
          if (n_out >= out_cap) return -1;
          out[n_out++] = peak_pos[k];
          peak_pos[k] = -1;
          peak_value[k] = cur;
          valid_peak[k] = false;
        }
      }
    }
  }
  return n_out;
}
