// The probe's iteration of fill_loop_probe.cuh on the host (built with g++
// by the CPU tests), on a C-contiguous int32 ring [w, b], column by column:
//   rh_probe_serial  rh_probe_column, the serial order;
//   rh_probe_warp    the instance the kernel picks for (w, k_ops) with the
//                    32 lanes as a loop (rh_probe_regs up to w = 256,
//                    rh_probe_smem past it); returns its SPL (0: the memory
//                    form);
//   rh_probe_chain1  rh_probe_chain on one value.
#include <stddef.h>

#include <vector>

#include "fill_loop_probe.cuh"

namespace {

struct HostRun {
  int* ring;
  int w, b, n_iter, k_ops;
  template <int SPL, int K>
  int run() {
    std::vector<int> col(w);
    for (int c = 0; c < b; ++c) {
      for (int s = 0; s < w; ++s) col[s] = ring[(size_t)s * b + c];
      if constexpr (SPL == 0) {
        rh_probe_smem<K>(RhProbeHostWarp{}, col.data(), w, n_iter, k_ops);
      } else {
        RhProbeHostWarp::V<RhProbeRegs<SPL>> regs;
        for (int l = 0; l < 32; ++l)
          for (int j = 0; j < SPL; ++j) {
            const int s = l + 32 * j;
            regs[l].r[j] = s < w ? col[s] : RH_PROBE_INT32_MIN;
          }
        rh_probe_regs<SPL, K>(RhProbeHostWarp{}, regs, w, n_iter, k_ops);
        for (int s = 0; s < w; ++s) col[s] = regs[s & 31].r[s >> 5];
      }
      for (int s = 0; s < w; ++s) ring[(size_t)s * b + c] = col[s];
    }
    return SPL;
  }
};

}  // namespace

extern "C" {

void rh_probe_serial(int* ring, int w, int b, int n_iter, int k_ops) {
  std::vector<int> col(w);
  for (int c = 0; c < b; ++c) {
    for (int s = 0; s < w; ++s) col[s] = ring[(size_t)s * b + c];
    rh_probe_column(col.data(), w, n_iter, k_ops);
    for (int s = 0; s < w; ++s) ring[(size_t)s * b + c] = col[s];
  }
}

int rh_probe_warp(int* ring, int w, int b, int n_iter, int k_ops) {
  HostRun h{ring, w, b, n_iter, k_ops};
  return rh_probe_pick(w, k_ops, h);
}

int rh_probe_chain1(int r, int acc, int k_ops) { return rh_probe_chain(r, acc, k_ops); }

}  // extern "C"
