// The peak detector of events_peaks.cuh on the host (built with g++ by
// _build.py::load_host_library), a read at a time, as the kernel's two
// warps step each read: a tile of 32 positions of the short detector, its
// emissions and handoff words kept, then the tile's long steps reading the
// words.  The tests hold it against the plain version.
// Arrays are C-contiguous: ts1, ts2 f32 [b, l]; n_sig i32 [b]; out i32
// [b, 2 l].
#include <stddef.h>

#include "events_peaks.cuh"

extern "C" void rh_peaks_host(const float* ts1, const float* ts2,
                              const int* n_sig, int* out, int b, int l,
                              float t1, float t2, float ph, int w1, int half1,
                              int half2) {
  const RhPeakParams P = {t1, t2, ph, w1, half1, half2};
  const int kTile = 32;
  for (int r = 0; r < b; ++r) {
    const size_t a = (size_t)r * l;
    int n = n_sig[r];
    n = n < 0 ? 0 : (n > l ? l : n);
    RhPeakDet d0 = rh_peak_fresh(), d1 = rh_peak_fresh();
    int masked_to = 0;
    for (int t0 = 0; t0 < l; t0 += kTile) {
      int hand[kTile];
      // a whole tile, as the kernel unrolls it: past l nothing is live
      for (int j = 0; j < kTile; ++j) {
        const int i = t0 + j;
        int e0;
        hand[j] = rh_peaks_short(&d0, i < l ? ts1[a + i] : 0.0f, i,
                                 j < n - t0 && (j > 0 || t0 > 0), P, &e0);
        if (i < l) out[2 * (a + i)] = e0;
      }
      for (int j = 0; j < kTile; ++j) {
        const int i = t0 + j;
        const int e1 = rh_peaks_long(&d1, &masked_to, i < l ? ts2[a + i] : 0.0f,
                                     i, j < n - t0, hand[j], P);
        if (i < l) out[2 * (a + i) + 1] = e1;
      }
    }
  }
}
