// The ordered sums of ordered_scan.cuh on the host (built with g++ by
// _build.py::load_host_library), a row at a time, level by level as the
// kernels run them: the tests hold them against the plain versions.
// x: f32 rows of n values, row r at x + r * stride; out: f32 C-contiguous
// [b, n] (rh_cumsum_host) or [b] (rh_sum_host).
#include <stddef.h>

#include <vector>

#include "ordered_scan.cuh"

extern "C" void rh_cumsum_host(const float* x, long long stride, float* out,
                               int b, int n) {
  int sizes[RH_SCAN_MAX_LEVELS];
  const int top = rh_cumsum_levels(n, sizes);
  std::vector<std::vector<float>> lev(top + 1);
  for (int j = 1; j <= top; ++j) lev[j].resize(sizes[j]);
  for (int r = 0; r < b; ++r) {
    const float* row = x + r * stride;
    float* dst0 = out + (size_t)r * n;
    for (int j = 0; j < top; ++j)
      for (int k = 0; k < sizes[j + 1]; ++k)
        lev[j + 1][k] = rh_cumsum_block_total(j ? lev[j].data() : row, sizes[j], k);
    if (top) rh_cumsum_top(lev[top].data(), sizes[top], lev[top].data());
    else rh_cumsum_top(row, n, dst0);
    for (int j = top - 1; j >= 0; --j)
      for (int k = 0; k < sizes[j + 1]; ++k)
        rh_cumsum_block_out(j ? lev[j].data() : row, sizes[j], k,
                            k ? lev[j + 1][k - 1] : 0.0f,
                            j ? lev[j].data() : dst0);
  }
}

extern "C" void rh_sum_host(const float* x, long long stride, float* out, int b,
                            int n) {
  int sizes[RH_SCAN_MAX_LEVELS], fronts[RH_SCAN_MAX_LEVELS];
  const int top = rh_sum_levels(n, sizes, fronts);
  std::vector<std::vector<float>> lev(top + 1);
  for (int j = 1; j <= top; ++j) lev[j].resize(sizes[j]);
  for (int r = 0; r < b; ++r) {
    const float* row = x + r * stride;
    for (int j = 0; j < top; ++j)
      for (int k = 0; k < sizes[j + 1]; ++k)
        lev[j + 1][k] = rh_sum_window(j ? lev[j].data() : row, sizes[j], fronts[j], k);
    out[r] = rh_sum_top(top ? lev[top].data() : row, sizes[top]);
  }
}
