// The fill-loop-overhead probe's iteration, shared by the CUDA kernel
// (fill_loop_probe.cu) and a host build of the same logic
// (fill_loop_probe_host.cpp, which the CPU tests build with g++).
//
// The probe is tools/profiling/fill_loop_overhead.py's loop body: with acc
// the carry, every slot r of a column goes through k_ops steps of
// r = max(r + 1, acc); acc becomes the column max of the results, and slot
// i % W of the ring is set to acc.  int32 adds wrap, as they do in jax and
// torch, so they are written through unsigned (signed overflow is undefined
// in C++).
//
// Three forms give the same ring bit for bit:
//   - rh_probe_column: one column serially, the order the others are held to;
//   - rh_probe_regs<SPL, K_OPS>: a column on the 32 lanes of a warp, lane l
//     holding slots l, l + 32, ... in a register array of SPL = ceil(W/32)
//     entries (W <= 256);
//   - rh_probe_smem<K_OPS>: the same with the ring in (shared) memory, for
//     any W; lane l still owns slots l, l + 32, ..., so no lane reads
//     another's slots.
// Both warp forms are templates over the warp (RhProbeDevWarp on the card,
// RhProbeHostWarp with the lanes as a loop) and over K_OPS: k_ops fixed at
// compile time, or K_OPS < 0 for a k_ops read at run time.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RH_PROBE_HD __host__ __device__ __forceinline__
#define RH_PROBE_FN __device__ __forceinline__
#else
#define RH_PROBE_HD static inline
#define RH_PROBE_FN static inline
#endif

#define RH_PROBE_INT32_MIN (-2147483647 - 1)
// the widest ring the register form holds: 8 entries a lane
#define RH_PROBE_REG_W 256

// one step of a slot's chain
RH_PROBE_HD int rh_probe_step(int r, int acc) {
  const int r1 = (int)((uint32_t)r + 1u);
  return r1 > acc ? r1 : acc;
}

// the k_ops chain on one slot value, with the carry acc
RH_PROBE_HD int rh_probe_chain(int r, int acc, int k_ops) {
  for (int k = 0; k < k_ops; ++k) r = rh_probe_step(r, acc);
  return r;
}

// K_OPS steps, or k_ops of them when K_OPS < 0
template <int K_OPS>
RH_PROBE_HD int rh_probe_run(int r, int acc, int k_ops) {
  if (K_OPS < 0) return rh_probe_chain(r, acc, k_ops);
#pragma unroll
  for (int k = 0; k < K_OPS; ++k) r = rh_probe_step(r, acc);
  return r;
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
    ring[i % w] = acc;
  }
  return acc;
}

// ---- a column on a warp -----------------------------------------------------

// A lane's entries of the register form.
template <int SPL>
struct RhProbeRegs {
  int r[SPL];
};

// One lane's step in the register form: chains its entries k_ops times,
// interleaved (the SPL chains are independent), and returns its max.  The
// last entry holds a slot only on lanes below `tail` (W not a multiple of
// 32): elsewhere it keeps its value and stays out of the max, since with
// wrap-around a chained dummy can pass every real slot.  The max is a tree,
// ceil(log2 SPL) deep.  Every index is a constant once unrolled, so the
// entries stay in registers.
template <int SPL, int K_OPS>
RH_PROBE_HD int rh_probe_lane(int (&r)[SPL], int acc, bool last_live,
                              int k_ops) {
  const int keep = r[SPL - 1];
  if (K_OPS >= 0) {
#pragma unroll
    for (int k = 0; k < K_OPS; ++k)
#pragma unroll
      for (int j = 0; j < SPL; ++j) r[j] = rh_probe_step(r[j], acc);
  } else {
#pragma unroll 4
    for (int k = 0; k < k_ops; ++k)
#pragma unroll
      for (int j = 0; j < SPL; ++j) r[j] = rh_probe_step(r[j], acc);
  }
  if (!last_live) r[SPL - 1] = keep;
  int t[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) t[j] = r[j];
  t[SPL - 1] = last_live ? r[SPL - 1] : RH_PROBE_INT32_MIN;
#pragma unroll
  for (int h = 1; h < SPL; h *= 2)
#pragma unroll
    for (int j = 0; j + h < SPL; j += 2 * h) t[j] = t[j + h] > t[j] ? t[j + h] : t[j];
  return t[0];
}

// The owner of `slot` (lane slot % 32, entry slot / 32) takes acc: a select
// on every entry, so the array is never indexed at run time.
template <int SPL>
RH_PROBE_HD void rh_probe_put(int (&r)[SPL], int acc, int slot, int lane) {
  const bool mine = lane == (slot & 31);
  const int js = slot >> 5;
#pragma unroll
  for (int j = 0; j < SPL; ++j) r[j] = mine && j == js ? acc : r[j];
}

// One lane's step in the memory form: its slots lane, lane + 32, ... < w,
// four at a time with their chains interleaved as in the register form.
template <int K_OPS>
RH_PROBE_HD int rh_probe_lane_mem(int* ring, int lane, int w, int acc,
                                  int k_ops) {
  int m = RH_PROBE_INT32_MIN;
  int s = lane;
#pragma unroll 2
  for (; s + 96 < w; s += 128) {
    int r[4] = {ring[s], ring[s + 32], ring[s + 64], ring[s + 96]};
    const int g = rh_probe_lane<4, K_OPS>(r, acc, true, k_ops);
#pragma unroll
    for (int j = 0; j < 4; ++j) ring[s + 32 * j] = r[j];
    m = g > m ? g : m;
  }
  for (; s < w; s += 32) {
    int r[1] = {ring[s]};
    const int g = rh_probe_lane<1, K_OPS>(r, acc, true, k_ops);
    ring[s] = r[0];
    m = g > m ? g : m;
  }
  return m;
}

// n_iter iterations of a column of w <= 32 * SPL slots in registers; ring[l]
// holds lane l's entries (slots l + 32 j; a missing slot's entry is never
// read).  The slot to write is a running counter, not i % w.
template <int SPL, int K_OPS, class W>
RH_PROBE_FN void rh_probe_regs(const W& warp,
                               typename W::template V<RhProbeRegs<SPL>>& ring,
                               int w, int n_iter, int k_ops) {
  using VI = typename W::template V<int>;
  const int tail = w - 32 * (SPL - 1);
  int acc = RH_PROBE_INT32_MIN;
  int slot = 0;
  for (int i = 0; i < n_iter; ++i) {
    VI m;
    warp.lanes([&](int l) {
      m[l] = rh_probe_lane<SPL, K_OPS>(ring[l].r, acc, l < tail, k_ops);
    });
    acc = warp.max(m);
    warp.lanes([&](int l) { rh_probe_put<SPL>(ring[l].r, acc, slot, l); });
    slot = slot + 1 == w ? 0 : slot + 1;
  }
}

// n_iter iterations of a column of w slots in ring (memory the warp alone
// uses).  Each slot is read and written by its own lane only, so the warp
// needs no barrier beside the column max.
template <int K_OPS, class W>
RH_PROBE_FN void rh_probe_smem(const W& warp, int* ring, int w, int n_iter,
                               int k_ops) {
  using VI = typename W::template V<int>;
  int acc = RH_PROBE_INT32_MIN;
  int slot = 0;
  for (int i = 0; i < n_iter; ++i) {
    VI m;
    warp.lanes([&](int l) { m[l] = rh_probe_lane_mem<K_OPS>(ring, l, w, acc, k_ops); });
    acc = warp.max(m);
    warp.lanes([&](int l) {
      if (l == (slot & 31)) ring[slot] = acc;
    });
    slot = slot + 1 == w ? 0 : slot + 1;
  }
}

// The instance for (w, k_ops), host code: f.template run<SPL, K>() with SPL the
// register form's entries a lane (0: the memory form, past
// RH_PROBE_REG_W) and K the k_ops fixed at compile time (2, 20 or 60, the
// entry point's) or -1.
template <int SPL, class F>
inline int rh_probe_pick_k(int k_ops, F& f) {
  switch (k_ops) {
    case 2: return f.template run<SPL, 2>();
    case 20: return f.template run<SPL, 20>();
    case 60: return f.template run<SPL, 60>();
    default: return f.template run<SPL, -1>();
  }
}

template <class F>
inline int rh_probe_pick(int w, int k_ops, F& f) {
  switch (w > RH_PROBE_REG_W ? 0 : (w + 31) / 32) {
    case 1: return rh_probe_pick_k<1>(k_ops, f);
    case 2: return rh_probe_pick_k<2>(k_ops, f);
    case 3: return rh_probe_pick_k<3>(k_ops, f);
    case 4: return rh_probe_pick_k<4>(k_ops, f);
    case 5: return rh_probe_pick_k<5>(k_ops, f);
    case 6: return rh_probe_pick_k<6>(k_ops, f);
    case 7: return rh_probe_pick_k<7>(k_ops, f);
    case 8: return rh_probe_pick_k<8>(k_ops, f);
    default: return rh_probe_pick_k<0>(k_ops, f);
  }
}

// A warp on the host: 32 lanes as a loop, lane values as arrays (as
// chain_backtrack.cuh's RhHostWarp, reduced to what the probe uses).
struct RhProbeHostWarp {
  template <class T>
  struct V {
    T v[32];
    T& operator[](int l) { return v[l]; }
  };
  template <class F>
  void lanes(F fn) const {
    for (int l = 0; l < 32; ++l) fn(l);
  }
  int max(V<int>& x) const {
    int m = x[0];
    for (int l = 1; l < 32; ++l) m = x[l] > m ? x[l] : m;
    return m;
  }
};

#ifdef __CUDACC__
// A warp on the card: one lane's value in a register; the column max is one
// REDUX (__reduce_max_sync), which also joins the warp.
struct RhProbeDevWarp {
  template <class T>
  struct V {
    T v;
    __device__ T& operator[](int) { return v; }
  };
  template <class F>
  __device__ void lanes(F fn) const { fn((int)(threadIdx.x & 31)); }
  __device__ int max(V<int>& x) const { return __reduce_max_sync(0xffffffffu, x.v); }
};
#endif
