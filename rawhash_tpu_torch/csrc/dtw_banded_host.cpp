// The banded DTW of dtw_banded.cuh on the host (built with g++ by
// _build.py::load_host_library), as the kernel runs it: each position of
// the order on the warp path (rh_dtw_pair_warp, the 32 lanes as a loop)
// or the thread path (rh_dtw_pair, its band in one array, stride 1), by
// the kernel's own rule (rh_dtw_takes_warp); the tests hold it against the
// plain version.  Arguments as rh_dtw_banded's in dtw_banded.cu, host
// arrays.  Returns 0, or -1 when r < 0, cap < 1 or memory cannot be
// allocated.
#include <stdlib.h>

#include "dtw_banded.cuh"

namespace {

template <int N, int L>
void run(const float* a, const int* a_off, const int* a_len, const float* b,
         const int* b_off, const int* b_len, const int* radius, const int* order,
         float* out, int pairs, int r, int cap, int threshold, int long_warps,
         float* band, float* warp_mem) {
  const int slots = 2 * r + 1 + RH_DTW_PAD;
  for (int k = 0; k < pairs; ++k) {
    const int p = order[k];
    const int cols = a_len[p] < cap ? a_len[p] : cap;
    if constexpr (L > 0) {
      if (rh_dtw_takes_warp(k, cols, long_warps, threshold)) {
        out[p] = rh_dtw_pair_warp<RhDtwHostWarp, N, L>(
            RhDtwHostWarp(), a + a_off[p], a_len[p], b + b_off[p], b_len[p], cap,
            radius[p], r, warp_mem);
        continue;
      }
    }
    out[p] = rh_dtw_pair<N>(a + a_off[p], a_len[p], b + b_off[p], b_len[p], cap,
                            radius[p], r, RhDtwBand{band, band + slots, 1});
  }
}

template <int N>
int run_lag(int lag, const float* a, const int* a_off, const int* a_len,
            const float* b, const int* b_off, const int* b_len, const int* radius,
            const int* order, float* out, int pairs, int r, int cap, int threshold,
            int long_warps, float* band, float* warp_mem) {
  switch (lag) {
#define RH_DTW_L(L)                                                          \
  case L:                                                                    \
    run<N, L>(a, a_off, a_len, b, b_off, b_len, radius, order, out, pairs, r, \
              cap, threshold, long_warps, band, warp_mem);                   \
    return 0;
    RH_DTW_L(2) RH_DTW_L(3) RH_DTW_L(4) RH_DTW_L(5)
    RH_DTW_L(6) RH_DTW_L(7) RH_DTW_L(8)
#undef RH_DTW_L
  }
  return -1;
}

}  // namespace

extern "C" {

int rh_dtw_banded_host(const float* a, const int* a_off, const int* a_len,
                       const float* b, const int* b_off, const int* b_len,
                       const int* radius, const int* order, float* out, int pairs,
                       int r, int cap, int threshold, int long_warps) {
  if (r < 0 || cap < 1) return -1;
  const long long w = 2LL * r + 1;
  const int lag = w >= 32 * RH_DTW_MAX_LAG ? 0 : rh_dtw_default_lag((int)w);
  float* band = (float*)malloc(2 * (w + RH_DTW_PAD) * sizeof(float));
  float* warp_mem =
      lag ? (float*)malloc(rh_dtw_warp_floats((int)w, lag) * sizeof(float)) : NULL;
  int rc = band == NULL || (lag && warp_mem == NULL) ? -1 : 0;
  if (rc == 0) {
    const int n = rh_dtw_levels(w);
    if (lag == 0) {
      switch (n) {
#define RH_DTW_CASE(N)                                                         \
  case N:                                                                      \
    run<N, 0>(a, a_off, a_len, b, b_off, b_len, radius, order, out, pairs, r,  \
              cap, threshold, 0, band, warp_mem);                              \
    break;
        RH_DTW_CASE(3) RH_DTW_CASE(4) RH_DTW_CASE(5)
        RH_DTW_CASE(6) RH_DTW_CASE(7) RH_DTW_CASE(8)
#undef RH_DTW_CASE
      }
    } else if (n == 1) {
      rc = run_lag<1>(lag, a, a_off, a_len, b, b_off, b_len, radius, order, out,
                      pairs, r, cap, threshold, long_warps, band, warp_mem);
    } else {
      rc = run_lag<2>(lag, a, a_off, a_len, b, b_off, b_len, radius, order, out,
                      pairs, r, cap, threshold, long_warps, band, warp_mem);
    }
  }
  free(band);
  free(warp_mem);
  return rc;
}

// The warp path's lag at a band width (0: none).
int rh_dtw_warp_lag_host(int width) { return rh_dtw_default_lag(width); }

// Column i's center for i < cols, by the closed form (closed) and by the
// plain version's stepped rule from center 0 (stepped).
void rh_dtw_centers_host(int a_len, int b_len, int cols, int* closed, int* stepped) {
  int center = 0;
  for (int i = 0; i < cols; ++i) {
    if (i > 0) center = rh_dtw_step(center, i, a_len, b_len);
    stepped[i] = center;
    closed[i] = rh_dtw_center(i, a_len, b_len);
  }
}

}  // extern "C"
