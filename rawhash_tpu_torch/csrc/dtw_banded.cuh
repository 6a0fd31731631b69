// The slanted-band DTW of dtw/device.py::dtw_banded_batch_plain, one pair
// at a time, shared by the CUDA kernel (dtw_banded.cu, a thread a pair) and
// a host build of the same logic (dtw_banded_host.cpp, which the CPU tests
// build with g++).
//
// The plain version steps a batch one band column at a time: the band has
// w = 2 r + 1 slots (r = max_radius), slot s of column i holds row
// j = center_i + s - r, and each column is
//     cost[s] = |a[i] - b[clamp(j)]|
//     bm[s]   = min(min(left[s], topleft[s]) + cost[s], BIG)
//     new[s]  = cummin(bm - csum)[s] + csum[s],  csum = cumsum(cost)
//     dp[s]   = valid[s] ? min(new[s], BIG) : BIG
// with every slot in the sums and the running minimum, inside the pair's
// radius and b or not.  Here a pair runs its columns alone, up to its own
// a_len (the plain version freezes a pair's dp and center past it), and
// walks each column's slots in order, so:
//   - csum is XLA's CPU order as the plain version's `_cumsum` takes it
//     (sequential inside blocks of 16 slots, the block totals summed the
//     same way one level up, recursively, each slot's sum the total of the
//     blocks before it plus its own block's running sum): RhXlaLevel keeps
//     each level's running sums and hands a block's total up when the block
//     ends, so a slot's csum is ready when the slot is;
//   - the running minimum is the cummin (exact in any order);
//   - the band's slots, in `dp` and in `win` (b[clamp(j)] of each slot's
//     row), are updated in place in order: slot s reads the old slots
//     s - 1 (kept in a register), s and s + 1 (each loaded three slots
//     before, so a slot never waits for its loads).  After a slide (center + 1)
//     slot s takes old slot s + 1's row: left = dp_prev[s + 1], topleft =
//     dp_prev[s], b from win[s + 1]; else left = dp_prev[s], topleft =
//     dp_prev[s - 1].  The slot past the band holds BIG in `dp` (the left
//     of a slide's new top row) and the new row's b value, read a column
//     ahead, in `win`; topleft of slot 0 without a slide is BIG.  The
//     reference's guard (topleft BIG at row 0's slot after a slide while
//     center - radius <= 0) needs no code: that topleft is dp_prev of row
//     -1, never valid, so BIG in every column;
//   - a column's level-0 sums are taken a block of 16 slots at a time, so
//     a slot's place in its block is a constant of the unrolled loop (the
//     last block's slots, fewer than 16, a loop of their own).
// Every float operation rounds on its own: build with --fmad=false (nvcc)
// and -ffp-contract=off (g++).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RH_DTW_HD __host__ __device__ __forceinline__
#define RH_DTW_MEMBER __host__ __device__ __forceinline__
#else
#define RH_DTW_HD static inline
#define RH_DTW_MEMBER inline
#endif

#define RH_DTW_BIG 1e10f  // the plain version's BIG, exact in f32
#define RH_DTW_BLOCK 16   // XLA's scan block

// the levels of XLA's blocked prefix sum of n values: 1 up to 16, one more
// for each factor of 16 past it
RH_DTW_HD int rh_dtw_levels(long long n) {
  int levels = 1;
  while (n > RH_DTW_BLOCK) {
    n = (n + RH_DTW_BLOCK - 1) / RH_DTW_BLOCK;
    ++levels;
  }
  return levels;
}

// One level of the prefix sum, M levels from it to the top, fed one value
// at a time; push returns that value's prefix sum at this level.  A level
// of more than 16 values (M > 1) sums inside blocks of 16 and adds the
// prefix sum of the block totals before the block (0 for the first), which
// the level above gives as each block ends; the top level (M = 1, at most
// 16 values) sums in order.
template <int M>
struct RhXlaLevel {
  float inner, excl;
  int pos;
  RhXlaLevel<M - 1> up;
  RH_DTW_MEMBER void init() {
    inner = excl = 0.0f;
    pos = 0;
    up.init();
  }
  RH_DTW_MEMBER float push(float v) {
    const int q = pos++ & (RH_DTW_BLOCK - 1);
    inner = q == 0 ? v : inner + v;
    const float out = excl + inner;
    if (q == RH_DTW_BLOCK - 1) excl = up.push(inner);
    return out;
  }
};

template <>
struct RhXlaLevel<1> {
  float acc;
  int pos;
  RH_DTW_MEMBER void init() {
    acc = 0.0f;
    pos = 0;
  }
  RH_DTW_MEMBER float push(float v) {
    acc = pos++ == 0 ? v : acc + v;
    return acc;
  }
};

// A pair's band, slot s's dp at dp[s * stride] and its b value at
// win[s * stride], s < w + 3 (RH_DTW_PAD slots past the band: the loads
// three slots ahead read them at the band's end).
#define RH_DTW_PAD 3
struct RhDtwBand {
  float* dp;
  float* win;
  long long stride;
  RH_DTW_MEMBER float& at(float* base, int s) const { return base[s * stride]; }
};

RH_DTW_HD int rh_dtw_clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A column's state as its slots are taken in order: the old dp of slots
// s - 1 .. s + 2 and the old b values of slots s .. s + 2 (for slot s),
// the level-0 running sum of the slot's block and the sum of the blocks
// before it, and the running minimum.
struct RhDtwColumn {
  float d_prev, d_cur, d_next, d_next2, w_cur, w_next, w_next2, inner, excl, cm;
};

// Slot s of a column (q: its place in its block of 16; inc: the band slid;
// ai: a's value; valid slots [lo, hi)): its new dp and b value stored in
// place, slot s + 3's old values loaded (two slots before they are
// read).
template <int N>
RH_DTW_HD void rh_dtw_slot(RhDtwColumn& c, const RhDtwBand& band, int s, int q,
                           bool inc, float ai, int lo, int hi) {
  const float big = RH_DTW_BIG;
  const float left = inc ? c.d_next : c.d_cur;
  const float topleft = inc ? c.d_cur : c.d_prev;
  const float bj = inc ? c.w_next : c.w_cur;
  const float cost = fabsf(ai - bj);
  const float bm = fminf(fminf(left, topleft) + cost, big);
  c.inner = q == 0 ? cost : c.inner + cost;
  const float cs = N == 1 ? c.inner : c.excl + c.inner;
  c.cm = fminf(c.cm, bm - cs);
  band.at(band.dp, s) = s >= lo && s < hi ? fminf(c.cm + cs, big) : big;
  band.at(band.win, s) = bj;
  c.d_prev = c.d_cur;
  c.d_cur = c.d_next;
  c.d_next = c.d_next2;
  c.w_cur = c.w_next;
  c.w_next = c.w_next2;
  c.d_next2 = band.at(band.dp, s + 3);
  c.w_next2 = band.at(band.win, s + 3);
}

// The banded DTW cost of one pair (a, b: rows of max_len values; the
// plain version's a_len, b_len, radius and max_radius r), its band in
// `band` (w + RH_DTW_PAD slots of each array, w = 2 r + 1).
// N = rh_dtw_levels(w).
template <int N>
RH_DTW_HD float rh_dtw_pair(const float* a, const float* b, int max_len,
                            int a_len, int b_len, int radius, int r,
                            RhDtwBand band) {
  const int w = 2 * r + 1;
  radius = radius < r ? radius : r;
  const float big = RH_DTW_BIG;

  // column 0: rows -r..r in slots 0..w-1; the cumulative cost down rows
  // 0..min(radius, b_len - 1), every slot summed
  RhXlaLevel<N> scan0;
  scan0.init();
  const float a0 = a[0];
  for (int s = 0; s < w; ++s) {
    const int j = s - r;
    const float bj = b[rh_dtw_clamp(j, 0, max_len - 1)];
    band.at(band.win, s) = bj;
    const float col = j >= 0 && j < b_len && j <= radius ? fabsf(a0 - bj) : big;
    const float cs = scan0.push(j >= 0 ? fminf(col, big) : 0.0f);
    band.at(band.dp, s) = col >= big ? big : (j >= 0 ? cs : big);
  }
  // past the band: dp BIG (the left of a slide's new top row), and b's
  // value of the row a slide brings in
  for (int s = w; s < w + RH_DTW_PAD; ++s) {
    band.at(band.dp, s) = big;
    band.at(band.win, s) = 0.0f;  // past w, read ahead and never used
  }

  const int cols = a_len < max_len ? a_len : max_len;  // a's row, no further
  int center = 0;
  float a_next = cols > 1 ? a[1] : 0.0f;
  float b_next = b[rh_dtw_clamp(1 + r, 0, max_len - 1)];  // row center + 1 + r
  for (int i = 1; i < cols; ++i) {
    const float ai = a_next;
    if (i + 1 < cols) a_next = a[i + 1];
    const int nxt = center + 1;
    const bool inc = (long long)nxt * a_len <= (long long)b_len * i;
    const int center2 = inc ? nxt : center;
    band.at(band.win, w) = b_next;
    b_next = b[rh_dtw_clamp(center2 + 1 + r, 0, max_len - 1)];
    // valid: j in [0, b_len) and |s - r| <= radius, slots [lo, hi)
    const int lo = r - center2 > r - radius ? r - center2 : r - radius;
    const int hi = b_len - center2 + r < r + radius + 1 ? b_len - center2 + r
                                                         : r + radius + 1;
    // the column's slots in order, in place: slot s reads the old slots
    // s - 1 (kept in a register), s and s + 1 (each loaded three slots
    // before it); after a slide, slot s takes the row of old slot s + 1
    RhDtwColumn c = {big, band.at(band.dp, 0), band.at(band.dp, 1),
                     band.at(band.dp, 2), band.at(band.win, 0),
                     band.at(band.win, 1), band.at(band.win, 2), 0.0f, 0.0f,
                     INFINITY};
    RhXlaLevel<N == 1 ? 1 : N - 1> up;  // the levels above the slots
    up.init();
    // whole blocks of 16 slots unrolled with no exit inside, so no slot
    // waits for a load to be copied to the next slot's register; then the
    // last block's slots
    int g = 0;
    for (; g + RH_DTW_BLOCK <= w; g += RH_DTW_BLOCK) {
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int q = 0; q < RH_DTW_BLOCK; ++q)
        rh_dtw_slot<N>(c, band, g + q, q, inc, ai, lo, hi);
      if (N > 1) c.excl = up.push(c.inner);
    }
    for (int s = g; s < w; ++s) rh_dtw_slot<N>(c, band, s, s - g, inc, ai, lo, hi);
    center = center2;
  }
  return band.at(band.dp, rh_dtw_clamp(b_len - 1 - center + r, 0, w - 1));
}
