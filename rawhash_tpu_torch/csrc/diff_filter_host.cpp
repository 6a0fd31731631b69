// The filter of diff_filter.cuh on the host (built with g++ by
// _build.py::load_host_library), in the kernel's order: reads in groups of
// 32, each group's reads stepped a tile at a time up to the tile that holds
// the group's longest read's last event (the live end), every tile's mask
// cut at the read's n and written as bytes, and every byte past the live
// end written 0 (the kernel's fill blocks).  The tests hold it against the
// plain version.  events f32 [b, e] and keep u8 [b, e] (0 or 1)
// C-contiguous; n_ev i32 [b].
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "diff_filter.cuh"

extern "C" void rh_diff_filter_host(const float* events, const int* n_ev,
                                    uint8_t* keep, int b, int e, float diff) {
  for (int row0 = 0; row0 < b; row0 += 32) {
    const int rows = b - row0 < 32 ? b - row0 : 32;
    int n_max = 0;
    for (int r = 0; r < rows; ++r) {
      const int n = n_ev[row0 + r] < 0 ? 0 : (n_ev[row0 + r] > e ? e : n_ev[row0 + r]);
      n_max = n > n_max ? n : n_max;
    }
    const int live_end =
        (n_max + RH_DF_TILE - 1) / RH_DF_TILE * RH_DF_TILE < e
            ? (n_max + RH_DF_TILE - 1) / RH_DF_TILE * RH_DF_TILE : e;
    for (int r = 0; r < rows; ++r) {
      const float* ev = events + (size_t)(row0 + r) * e;
      uint8_t* kp = keep + (size_t)(row0 + r) * e;
      const int n = n_ev[row0 + r] < 0 ? 0 : (n_ev[row0 + r] > e ? e : n_ev[row0 + r]);
      float last = ev[0];
      for (int t0 = 0; t0 < live_end; t0 += RH_DF_TILE) {
        float v[RH_DF_TILE];
        for (int j = 0; j < RH_DF_TILE; ++j) v[j] = t0 + j < e ? ev[t0 + j] : 0.0f;
        uint32_t m = rh_diff_tile(v, &last, diff) | (t0 == 0 ? 1u : 0u);
        m &= rh_diff_live(n - t0);
        uint32_t w[RH_DF_TILE / 4];
        rh_diff_bytes(m, w);
        uint8_t bytes[RH_DF_TILE];
        memcpy(bytes, w, sizeof bytes);
        for (int j = 0; j < RH_DF_TILE && t0 + j < e; ++j) kp[t0 + j] = bytes[j];
      }
      for (int t = live_end; t < e; ++t) kp[t] = 0;
    }
  }
}
