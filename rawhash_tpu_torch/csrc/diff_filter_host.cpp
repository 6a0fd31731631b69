// The filter of diff_filter.cuh on the host (built with g++ by
// _build.py::load_host_library), a read at a time, as the kernel steps
// each read: the tests hold it against the plain version.  events f32
// [b, e] and keep u8 [b, e] (0 or 1) C-contiguous; n_ev i32 [b].
#include <stddef.h>
#include <stdint.h>

#include "diff_filter.cuh"

extern "C" void rh_diff_filter_host(const float* events, const int* n_ev,
                                    uint8_t* keep, int b, int e, float diff) {
  for (int r = 0; r < b; ++r) {
    const size_t a = (size_t)r * e;
    float last = 0.0f;
    for (int t = 0; t < e; ++t)
      keep[a + t] = rh_diff_keep(events[a + t], t, n_ev[r], diff, &last);
  }
}
