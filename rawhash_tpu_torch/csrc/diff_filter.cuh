// The sketch's event-difference filter (reference: rsketch.c:95,187), a
// tile of 32 events of one read at a time, shared by the CUDA kernel
// (diff_filter.cu) and a host build of the same logic (diff_filter_host.cpp,
// which the CPU tests build with g++).
//
// It is sketch/device.py::_diff_filter_plain a tile at a time: event t of a
// read with n events is kept when it is the first (t = 0 < n) or differs
// by at least `diff` from the last kept event (0 before the first).
//
// The tile step keeps no liveness test on its chain: it steps all 32
// events, whether live or not, and the caller masks the bits at or past n
// once a tile (rh_diff_live); the events past n only move `last`, which no
// live event reads again.  Event 0 is taken before the first tile:
// `last` starts at event 0's own value, so the step leaves it there
// (|v - v| is 0, and a NaN compares false), and its bit is set by hand.
// Each event's step subtracts, compares and selects f32 values, so every
// build keeps the plain version's events bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RH_DF_HD __host__ __device__ __forceinline__
#else
#define RH_DF_HD static inline
#endif

// events a tile
#define RH_DF_TILE 32

// The keep bits of a tile's 32 events v (bit j: event j), stepped from
// *last, the last kept value, which follows.  The chain an event is a
// subtract, a compare of its magnitude and a select of `last`; the mask
// hangs off the compare.
RH_DF_HD uint32_t rh_diff_tile(const float (&v)[RH_DF_TILE], float* last,
                               float diff) {
  float l = *last;
  uint32_t m = 0;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < RH_DF_TILE; ++j) {
    const bool k = fabsf(v[j] - l) >= diff;
    l = k ? v[j] : l;
    m |= k ? (1u << j) : 0u;
  }
  *last = l;
  return m;
}

// The live bits of a tile whose first event is `rem` events before the
// read's n (all 32 when rem >= 32, none when rem <= 0).
RH_DF_HD uint32_t rh_diff_live(int rem) {
  return rem >= RH_DF_TILE ? 0xffffffffu : (rem <= 0 ? 0u : (1u << rem) - 1u);
}

// The keep bytes of a tile's mask, 0 or 1 each, as 8 little-endian words
// (byte j of the 32: bit j).  A nibble times 0x00204081 puts its bits 0-3
// at bits 0, 8, 16 and 24 with no carries (the four copies do not
// overlap).
RH_DF_HD void rh_diff_bytes(uint32_t m, uint32_t (&w)[RH_DF_TILE / 4]) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int q = 0; q < RH_DF_TILE / 4; ++q)
    w[q] = (((m >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
}
