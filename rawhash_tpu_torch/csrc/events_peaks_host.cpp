// The peak detector of events_peaks.cuh on the host (built with g++ by
// _build.py::load_host_library), a read at a time, as the kernel steps each
// read: the tests hold it against the plain version.
// Arrays are C-contiguous: ts1, ts2 f32 [b, l]; n_sig i32 [b]; out i32
// [b, 2 l].
#include <stddef.h>

#include "events_peaks.cuh"

extern "C" void rh_peaks_host(const float* ts1, const float* ts2,
                              const int* n_sig, int* out, int b, int l,
                              float t1, float t2, float ph, int w1, int half1,
                              int half2) {
  const RhPeakParams P = {t1, t2, ph, w1, half1, half2};
  for (int r = 0; r < b; ++r) {
    const size_t a = (size_t)r * l;
    int n = n_sig[r];
    n = n < 0 ? 0 : (n > l ? l : n);
    RhPeakRow st = rh_peak_row();
    for (int i = 0; i < l; ++i)
      rh_peaks_step(&st, ts1[a + i], ts2[a + i], i, n, P, out + 2 * (a + i),
                    out + 2 * (a + i) + 1);
  }
}
