// f32 row sums and prefix sums in one fixed order, the order XLA's CPU
// backend gives jnp.sum and jnp.cumsum (signal/events.py::ordered_sum_plain
// and ordered_cumsum_plain).  Shared by the CUDA kernels (ordered_scan.cu)
// and a host build of the same logic (ordered_scan_host.cpp, which the CPU
// tests build with g++).  Every add is a separate f32 add in the order
// written here, so every build gives the plain versions' sums bit for bit.
//
// Prefix sum of n values, by levels: level 0 is the row; while a level has
// more than 16 values, the next level holds the totals of its blocks of 16
// (zero past its end), each summed left to right from 0.  The top level
// (<= 16 values) is scanned left to right from 0.  Then, from the top down,
// each block's running sums plus the prefix of the blocks before it (0 for
// the first) replace the block: its scan.
//
// Sum of n values, by levels: while a level has more than 32 values, it is
// padded with zeros to a multiple of 32, half the padding in front, and the
// next level holds its windows of 32, each summed left to right from 0.
// The top level (<= 32 values) is summed left to right from 0.
//
// A block's or a window's values are one thread's work, so the levels are
// the only steps that wait for each other: the kernels run a row a block
// and its windows on the block's threads; the host build runs them in turn.
#pragma once

#ifdef __CUDACC__
#define RH_SC_HD __host__ __device__ __forceinline__
#else
#define RH_SC_HD static inline
#endif

#define RH_SCAN_BLOCK 16
#define RH_SUM_WINDOW 32
// levels of a row of up to 2^31 values (a level is 1/16 of the one below)
#define RH_SCAN_MAX_LEVELS 9

// The prefix sum's level sizes (sizes[0] = n); returns the top level's index.
RH_SC_HD int rh_cumsum_levels(int n, int* sizes) {
  int j = 0;
  sizes[0] = n;
  while (sizes[j] > RH_SCAN_BLOCK) {
    sizes[j + 1] = (sizes[j] + RH_SCAN_BLOCK - 1) / RH_SCAN_BLOCK;
    ++j;
  }
  return j;
}

// The total of block k of src (n values, zero past them).
RH_SC_HD float rh_cumsum_block_total(const float* src, int n, int k) {
  const int a = k * RH_SCAN_BLOCK;
  float acc = 0.0f;
  for (int r = 0; r < RH_SCAN_BLOCK; ++r)
    acc = acc + (a + r < n ? src[a + r] : 0.0f);
  return acc;
}

// Block k's running sums plus carry, the prefix of the blocks before it,
// into dst (may be src), up to n.
RH_SC_HD void rh_cumsum_block_out(const float* src, int n, int k, float carry,
                                  float* dst) {
  const int a = k * RH_SCAN_BLOCK;
  float acc = 0.0f;
  for (int r = 0; r < RH_SCAN_BLOCK && a + r < n; ++r) {
    acc = acc + src[a + r];
    dst[a + r] = acc + carry;
  }
}

// The top level's scan (n <= 16), into dst (may be src).
RH_SC_HD void rh_cumsum_top(const float* src, int n, float* dst) {
  float acc = 0.0f;
  for (int r = 0; r < n; ++r) {
    acc = acc + src[r];
    dst[r] = acc;
  }
}

// The sum's level sizes (sizes[0] = n) and each level's front padding;
// returns the top level's index.
RH_SC_HD int rh_sum_levels(int n, int* sizes, int* fronts) {
  int j = 0;
  sizes[0] = n;
  while (sizes[j] > RH_SUM_WINDOW) {
    const int p = (RH_SUM_WINDOW - sizes[j] % RH_SUM_WINDOW) % RH_SUM_WINDOW;
    fronts[j] = p / 2;
    sizes[j + 1] = (sizes[j] + p) / RH_SUM_WINDOW;
    ++j;
  }
  return j;
}

// Window k of src (n values after `front` zeros, zeros past them).
RH_SC_HD float rh_sum_window(const float* src, int n, int front, int k) {
  const int a = k * RH_SUM_WINDOW - front;
  float acc = 0.0f;
  for (int r = 0; r < RH_SUM_WINDOW; ++r)
    acc = acc + (a + r >= 0 && a + r < n ? src[a + r] : 0.0f);
  return acc;
}

// The top level's sum (n <= 32).
RH_SC_HD float rh_sum_top(const float* src, int n) {
  float acc = 0.0f;
  for (int r = 0; r < n; ++r) acc = acc + src[r];
  return acc;
}

// Shared-memory floats a row needs: the levels above the row.
RH_SC_HD long long rh_cumsum_scratch(int n) {
  int sizes[RH_SCAN_MAX_LEVELS];
  const int top = rh_cumsum_levels(n, sizes);
  long long s = 0;
  for (int j = 1; j <= top; ++j) s += sizes[j];
  return s;
}

RH_SC_HD long long rh_sum_scratch(int n) {
  int sizes[RH_SCAN_MAX_LEVELS], fronts[RH_SCAN_MAX_LEVELS];
  const int top = rh_sum_levels(n, sizes, fronts);
  long long s = 0;
  for (int j = 1; j <= top; ++j) s += sizes[j];
  return s;
}
