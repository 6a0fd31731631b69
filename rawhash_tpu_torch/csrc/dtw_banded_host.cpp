// The banded DTW of dtw_banded.cuh on the host (built with g++ by
// _build.py::load_host_library), a pair at a time as the kernel's threads
// run them, each pair's band in one array (stride 1): the tests
// hold it against the plain version.  a, b f32 [pairs, max_len] and out f32
// [pairs] C-contiguous; a_len, b_len, radius i32 [pairs].  Returns 0, or -1
// when r < 0, max_len < 1 or the band cannot be allocated.
#include <stdlib.h>

#include "dtw_banded.cuh"

namespace {

template <int N>
void run(const float* a, const int* a_len, const float* b, const int* b_len,
         const int* radius, float* out, int pairs, int max_len, int r,
         float* band) {
  const int slots = 2 * r + 1 + RH_DTW_PAD;
  for (int p = 0; p < pairs; ++p)
    out[p] = rh_dtw_pair<N>(a + (size_t)p * max_len, b + (size_t)p * max_len,
                            max_len, a_len[p], b_len[p], radius[p], r,
                            RhDtwBand{band, band + slots, 1});
}

}  // namespace

extern "C" int rh_dtw_banded_host(const float* a, const int* a_len,
                                  const float* b, const int* b_len,
                                  const int* radius, float* out, int pairs,
                                  int max_len, int r) {
  if (r < 0 || max_len < 1) return -1;
  const long long w = 2LL * r + 1;
  float* band = (float*)malloc(2 * (w + RH_DTW_PAD) * sizeof(float));
  if (band == NULL) return -1;
  switch (rh_dtw_levels(w)) {
#define RH_DTW_CASE(N) \
  case N:              \
    run<N>(a, a_len, b, b_len, radius, out, pairs, max_len, r, band); \
    break;
    RH_DTW_CASE(1) RH_DTW_CASE(2) RH_DTW_CASE(3) RH_DTW_CASE(4)
    RH_DTW_CASE(5) RH_DTW_CASE(6) RH_DTW_CASE(7) RH_DTW_CASE(8)
#undef RH_DTW_CASE
  }
  free(band);
  return 0;
}
