// The row programs of events_fused.cuh on the host (built with g++ by
// _build.py::load_host_library), as the kernels run them: a row at a time,
// each phase's RH_EV_THREADS threads as a loop, the row's scratch in the
// layout the kernels use, and the segments' sort through a tile where the
// kernel's row scratch would lie in global memory.  With rh_peaks_host
// (events_peaks_host.cpp) between them they are the three launches of
// events_fused.cu; the tests hold them against the plain
// detect_events_batch.
//
// rh_ev_norm_host: sig f32 [b, l] rows at sig + r * stride, slen, c_n i32
// [b], c_sum, c_sq f32 [b] -> o_sum, o_sq f32 [b], o_n, n_sig i32 [b],
// normc, ts1, ts2 f32 [b, l].  rh_ev_segments_host: em i32 [b, 2 l], normc
// f32 [b, l], n_sig i32 [b] -> ev f32 [b, e_cap], n_ev i32 [b].
// rh_ev_plan_host: the words of each program's row scratch, and whether
// each fits a block's shared memory, into out[4].
#include <stdlib.h>

#include "events_fused.cuh"

namespace {

struct HostTeam {
  int n;
  template <class F>
  void each(F f) {
    for (int t = 0; t < n; ++t) f(t, n);
  }
  int size() const { return n; }
  void atomic_add(int* p, int v) { *p += v; }
};

}  // namespace

extern "C" void rh_ev_norm_host(const float* sig, long long stride,
                                const int* slen, const float* c_sum,
                                const float* c_sq, const int* c_n, float* o_sum,
                                float* o_sq, int* o_n, float* normc, int* n_sig,
                                float* ts1, float* ts2, int b, int l, int w1,
                                int w2) {
  if (b <= 0 || l <= 0) return;
  RhEvNormPlan P;
  rh_ev_norm_plan(l, &P);
  const RhEvParams E = rh_ev_params(w1, w2);
  float* r = static_cast<float*>(malloc(4 * P.words));
  int part[RH_EV_PART];
  HostTeam tm = {RH_EV_THREADS};
  for (int row = 0; row < b; ++row) {
    const long long o = (long long)row * l;
    rh_ev_norm_row(tm, P, E, sig + row * stride, l, slen[row], c_sum[row],
                   c_sq[row], c_n[row], r, part, normc + o, ts1 + o, ts2 + o,
                   o_sum + row, o_sq + row, o_n + row, n_sig + row);
  }
  free(r);
}

extern "C" void rh_ev_segments_host(const int* em, const float* normc,
                                    const int* n_sig, float* ev, int* n_ev,
                                    int b, int l, int e_cap) {
  if (b <= 0 || l <= 0) return;
  RhEvSegPlan P;
  rh_ev_seg_plan(l, e_cap, &P);
  float* r = static_cast<float*>(malloc(4 * P.words));
  unsigned* tile = rh_ev_fits_shared(P.words)
                       ? nullptr
                       : static_cast<unsigned*>(malloc(4 * RH_EV_TILE));
  int part[RH_EV_PART];
  HostTeam tm = {RH_EV_THREADS};
  for (int row = 0; row < b; ++row)
    rh_ev_segments_row(tm, P, em + (long long)row * 2 * l,
                       normc + (long long)row * l, n_sig[row], l, e_cap, r,
                       part, tile, ev + (long long)row * e_cap, n_ev + row);
  free(r);
  free(tile);
}

extern "C" void rh_ev_plan_host(int l, int e_cap, long long* out) {
  RhEvNormPlan N;
  RhEvSegPlan S;
  rh_ev_norm_plan(l, &N);
  rh_ev_seg_plan(l, e_cap, &S);
  out[0] = N.words;
  out[1] = S.words;
  out[2] = rh_ev_fits_shared(N.words);
  out[3] = rh_ev_fits_shared(S.words);
}
