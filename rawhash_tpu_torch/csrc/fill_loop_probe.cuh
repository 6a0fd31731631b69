// One iteration of the fill-loop-overhead probe on one column of the [W, B]
// ring, shared by the CUDA kernel (fill_loop_probe.cu) and a host build of
// the same logic.
//
// The probe is tools/profiling/fill_loop_overhead.py's loop body: with acc
// the carry, every slot r of a column goes through k_ops steps of
// r = max(r + 1, acc); acc becomes the column max of the results, and slot
// i % W of the ring is set to acc.  int32 adds wrap, as they do in jax and
// torch, so they are written through unsigned (signed overflow is undefined
// in C++).
//
// Without nvcc the header compiles as plain C++, so the CPU tests hold this
// exact code against the plain PyTorch probe.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RH_PROBE_HD __host__ __device__ __forceinline__
#else
#define RH_PROBE_HD static inline
#endif

#define RH_PROBE_INT32_MIN (-2147483647 - 1)

// the k_ops chain on one slot value, with the carry acc
RH_PROBE_HD int rh_probe_chain(int r, int acc, int k_ops) {
  for (int k = 0; k < k_ops; ++k) {
    const int r1 = (int)((uint32_t)r + 1u);
    r = r1 > acc ? r1 : acc;
  }
  return r;
}

// the new value of slot s after iteration i: the column max acc in slot
// i % w, the chained value r elsewhere
RH_PROBE_HD int rh_probe_slot(int r, int acc, int s, int i, int w) {
  return s == i % w ? acc : r;
}

// Single-thread run of one column (w slots in ring, updated in place): the
// order of operations every parallel version must reproduce.  Returns the
// final carry.
RH_PROBE_HD int rh_probe_column(int* ring, int w, int n_iter, int k_ops) {
  int acc = RH_PROBE_INT32_MIN;
  for (int i = 0; i < n_iter; ++i) {
    int m = RH_PROBE_INT32_MIN;
    for (int s = 0; s < w; ++s) {
      ring[s] = rh_probe_chain(ring[s], acc, k_ops);
      m = ring[s] > m ? ring[s] : m;
    }
    acc = m;
    for (int s = 0; s < w; ++s) ring[s] = rh_probe_slot(ring[s], acc, s, i, w);
  }
  return acc;
}
