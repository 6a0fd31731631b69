// The sketch's event-difference filter (reference: rsketch.c:95,187), one
// read's step, shared by the CUDA kernel (diff_filter.cu) and a host build
// of the same logic (diff_filter_host.cpp, which the CPU tests build with
// g++).
//
// It is sketch/device.py::_diff_filter_plain an event at a time: event t of
// a read with n events is kept when it is the first (t = 0 < n) or differs
// by at least `diff` from the last kept event.  The step subtracts,
// compares and selects f32 values, so every build keeps the plain
// version's events bit for bit.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define RH_DF_HD __host__ __device__ __forceinline__
#else
#define RH_DF_HD static inline
#endif

// Whether event t (value v) is kept; *last, the last kept value (0 before
// the first), follows.
RH_DF_HD bool rh_diff_keep(float v, int t, int n, float diff, float* last) {
  const bool keep = t < n && (t == 0 || fabsf(v - *last) >= diff);
  if (keep) *last = v;
  return keep;
}
