// The slanted-band DTW of dtw/device.py::dtw_banded_batch_plain, one pair
// at a time, shared by the CUDA kernel (dtw_banded.cu) and a host build of
// the same logic (dtw_banded_host.cpp, which the CPU tests build with g++).
// A pair is read from ragged rows: a's values at a[0 .. a_len), b's at
// b[0 .. b_len), no further than `cap` values of either (the padded entry's
// row length; the ragged one passes INT_MAX).  Two ways to run a pair:
// rh_dtw_pair, a thread a pair (the kernel's short pairs), and
// rh_dtw_pair_warp, a warp a pair (its long pairs).
//
// The plain version steps a batch one band column at a time: the band has
// w = 2 r + 1 slots (r = max_radius), slot s of column i holds row
// j = center_i + s - r, and each column is
//     cost[s] = |a[i] - b[clamp(j)]|
//     bm[s]   = min(min(left[s], topleft[s]) + cost[s], BIG)
//     new[s]  = cummin(bm - csum)[s] + csum[s],  csum = cumsum(cost)
//     dp[s]   = valid[s] ? min(new[s], BIG) : BIG
// with every slot in the sums and the running minimum, inside the pair's
// radius and b or not.  Here b's reads clamp to the pair's own row
// (b[clamp(j, 0, b_len - 1)]), where the plain version clamps to its padded
// row: only slots with j >= b_len read another value, and those come after
// every valid slot of their column, so their costs reach no valid slot's
// prefix sum or running minimum, and their dp is BIG either way.
//
// Thread path (rh_dtw_pair): a pair runs its columns alone, up to its own
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
//
// Warp path (rh_dtw_pair_warp), a wavefront over a pair's columns, lane l
// taking columns 1 + l, 33 + l, ...: each lane walks its column's slots in
// order as the thread path does (the same prefix sum and running minimum),
// two steps behind the lane before it, whose dp it is handed by a shuffle.
// It rests on a fact of the recurrence: a column's center has a closed
// form (rh_dtw_center), so each lane finds its own column's center, and its
// costs and sums need nothing of the other columns but their dp.  The
// warp is a type: RhDtwDevWarp on the card, RhDtwHostWarp (32 lanes as a
// loop) in the host build, so the CPU tests hold the warp path too.
//
// Every float operation rounds on its own: build with --fmad=false (nvcc)
// and -ffp-contract=off (g++).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RH_DTW_HD __host__ __device__ __forceinline__
#define RH_DTW_MEMBER __host__ __device__ __forceinline__
#define RH_DTW_WARP_FN __device__ __forceinline__
#define RH_DTW_UNROLL _Pragma("unroll")
#else
#define RH_DTW_HD static inline
#define RH_DTW_MEMBER inline
#define RH_DTW_WARP_FN inline
#define RH_DTW_UNROLL
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

RH_DTW_HD int rh_dtw_clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// x[clamp(j, 0, n - 1)] of a row of n values; 0 (the padded rows' value)
// for a row with none
RH_DTW_HD float rh_dtw_read(const float* x, int j, int n) {
  return n > 0 ? x[rh_dtw_clamp(j, 0, n - 1)] : 0.0f;
}

// The plain version's center step at column i: center + 1 if the band
// slides there, else center.
RH_DTW_HD int rh_dtw_step(int center, int i, int a_len, int b_len) {
  return (long long)(center + 1) * a_len <= (long long)b_len * i ? center + 1 : center;
}

// The center of column i (0 <= i < a_len) in closed form: the stepped rule
// from center 0 gives floor(i b_len / a_len) when b_len <= a_len (the
// floor rises by 0 or 1 a column, and the band slides exactly when it
// rises), and i when b_len > a_len (it slides every column).
RH_DTW_HD int rh_dtw_center(int i, int a_len, int b_len) {
  if (i <= 0 || a_len <= 0) return 0;
  const long long c = (long long)i * b_len / a_len;
  return c < i ? (int)c : i;
}

// Whether the pair at position k of the order runs on a warp of its own
// (the kernel's first long_warps blocks, one a position): its columns
// (cols) reach `threshold`.  Every other position runs on a lane of the
// thread path.
RH_DTW_HD bool rh_dtw_takes_warp(int k, int cols, int long_warps, int threshold) {
  return k < long_warps && cols >= threshold;
}

// ---- the thread path -------------------------------------------------------

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

// The banded DTW cost of one pair (a, b: its rows; the plain version's
// a_len, b_len, radius and max_radius r; cap: the most values of a row
// read), a thread alone, its band in `band` (w + RH_DTW_PAD slots of each
// array, w = 2 r + 1).  N = rh_dtw_levels(w).
template <int N>
RH_DTW_HD float rh_dtw_pair(const float* a, int a_len, const float* b, int b_len,
                            int cap, int radius, int r, RhDtwBand band) {
  const int w = 2 * r + 1;
  radius = radius < r ? radius : r;
  const float big = RH_DTW_BIG;
  const int cols = a_len < cap ? a_len : cap;  // a's row, no further
  const int bn = b_len < cap ? b_len : cap;    // b's values read

  // column 0: rows -r..r in slots 0..w-1; the cumulative cost down rows
  // 0..min(radius, b_len - 1), every slot summed
  RhXlaLevel<N> scan0;
  scan0.init();
  const float a0 = rh_dtw_read(a, 0, cols);
  for (int s = 0; s < w; ++s) {
    const int j = s - r;
    const float bj = rh_dtw_read(b, j, bn);
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

  int center = 0;
  float a_next = cols > 1 ? a[1] : 0.0f;
  float b_next = rh_dtw_read(b, 1 + r, bn);  // row center + 1 + r
  for (int i = 1; i < cols; ++i) {
    const float ai = a_next;
    if (i + 1 < cols) a_next = a[i + 1];
    const int center2 = rh_dtw_step(center, i, a_len, b_len);
    const bool inc = center2 != center;
    band.at(band.win, w) = b_next;
    b_next = rh_dtw_read(b, center2 + 1 + r, bn);
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
      RH_DTW_UNROLL
      for (int q = 0; q < RH_DTW_BLOCK; ++q)
        rh_dtw_slot<N>(c, band, g + q, q, inc, ai, lo, hi);
      if (N > 1) c.excl = up.push(c.inner);
    }
    for (int s = g; s < w; ++s) rh_dtw_slot<N>(c, band, s, s - g, inc, ai, lo, hi);
    center = center2;
  }
  return band.at(band.dp, rh_dtw_clamp(b_len - 1 - center + r, 0, w - 1));
}

// ---- the warp path ---------------------------------------------------------

// A warp on the host: 32 lanes as a loop, a lane value an array.
struct RhDtwHostWarp {
  template <class T>
  struct V {
    T v[32];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  template <class F>
  void lanes(F fn) const {
    for (int l = 0; l < 32; ++l) fn(l);
  }
  // lane l gets lane l - 1's value, lane 0 lane 31's
  template <class T>
  V<T> rotate(const V<T>& x) const {
    V<T> y;
    for (int l = 0; l < 32; ++l) y[l] = x[(l + 31) & 31];
    return y;
  }
  // every lane gets lane src's value
  template <class T>
  T bcast(const V<T>& x, int src) const { return x[src]; }
  void sync() const {}
};

#ifdef __CUDACC__
// A warp on the card: a lane's value in a register, the intrinsics.
struct RhDtwDevWarp {
  template <class T>
  struct V {
    T v;
    __device__ T& operator[](int) { return v; }
    __device__ const T& operator[](int) const { return v; }
  };
  template <class F>
  __device__ void lanes(F fn) const { fn((int)(threadIdx.x & 31)); }
  template <class T>
  __device__ V<T> rotate(const V<T>& x) const {
    return {__shfl_sync(0xffffffffu, x.v, (int)((threadIdx.x + 31) & 31))};
  }
  template <class T>
  __device__ T bcast(const V<T>& x, int src) const {
    return __shfl_sync(0xffffffffu, x.v, src);
  }
  __device__ void sync() const { __syncwarp(); }
};
#endif

// The warp path's lag at a band of w slots: 2, or more where a
// lane's column would not end before its next one starts (w < 32 L); 0
// (no warp path) past 32 x RH_DTW_MAX_LAG - 1 slots.
#define RH_DTW_MAX_LAG 8
RH_DTW_HD int rh_dtw_default_lag(int w) {
  const int lag = w / 32 + 1;
  return lag > RH_DTW_MAX_LAG ? 0 : (lag < 2 ? 2 : lag);
}

// The warp path's shared memory at band width w and lag L, in floats:
// column 0 and the pair's cost (w + 1), then two buffers of b's values of
// a round's rows (32 (L + 2) each).
RH_DTW_HD int rh_dtw_warp_floats(int w, int L) { return w + 1 + 2 * 32 * (L + 2); }

// The banded DTW cost of one pair (as rh_dtw_pair) on the warp `wp`, every
// lane returning it, as a wavefront over the columns: lane 0 takes column
// 0 alone into m, then lane l takes columns 1 + l, 33 + l, ... in turn,
// column c's slot s at step L (c - 1) + s (L, the lag, >= 2 with
// w < 32 L: a lane ends a column before its next starts).  So slot s of
// column c, which needs slots s - 1 .. s + 1 of column c - 1, runs L - 1
// steps after the slot s + 1 of column c - 1 on the lane before: each step
// every lane hands its new dp to the next lane (one shuffle, lane 31's to
// lane 0, which before its first column hands on column 0 from m), and a
// lane keeps the last L + 1 it was handed.  Within its column a lane walks
// the slots in order, so its prefix sum is XLA's order as the thread path
// takes it, and its running minimum the cummin.
//
// The steps go in rounds of 32 L: in round R lane l takes column
// 1 + l + 32 R at the round's step L l.  A column's center has a closed
// form (rh_dtw_center), so at a round's start every lane works out its
// next column's constants at once (its center carried as a quotient and
// remainder of 32 b_len / a_len, no division), and the lane that takes its
// column at a step only selects them.  A round's rows of b (its columns'
// centers lie within 62 of each other, so 32 (L + 2) rows hold them) are
// loaded a round ahead into registers and stored into the other of two
// shared buffers, so a step reads b from shared memory.  A step's chain is
// the handed dp, a select, five mins and adds, a select and the shuffle;
// the call takes L (columns - 2) + w steps.  N = rh_dtw_levels(w) <= 2;
// m: rh_dtw_warp_floats(w, L) floats of the warp's shared memory.
template <class W, int N, int L>
RH_DTW_WARP_FN float rh_dtw_pair_warp(const W& wp, const float* a, int a_len,
                                      const float* b, int b_len, int cap,
                                      int radius, int r, float* m) {
  static_assert(N <= 2 && L >= 2, "the warp path takes bands of up to 255 slots");
  typedef typename W::template V<float> VF;
  typedef typename W::template V<int> VI;
  constexpr int kSpan = 32 * (L + 2);  // rows a round reads, at most
  constexpr int kOff = -(1 << 29);     // a lane's slot off a column
  const int w = 2 * r + 1;
  radius = radius < r ? radius : r;
  const float big = RH_DTW_BIG;
  const int cols = a_len < cap ? a_len : cap;
  const int bn = b_len < cap ? b_len : cap;
  float* win = m + w + 1;
  // column 0, and the cost if it is the pair's only column
  wp.lanes([&](int l) {
    if (l != 0) return;
    RhXlaLevel<N> scan;
    scan.init();
    const float a0 = rh_dtw_read(a, 0, cols);
    for (int s = 0; s < w; ++s) {
      const int j = s - r;
      const float bj = rh_dtw_read(b, j, bn);
      const float col = j >= 0 && j < b_len && j <= radius ? fabsf(a0 - bj) : big;
      const float cs = scan.push(j >= 0 ? fminf(col, big) : 0.0f);
      m[s] = col >= big ? big : (j >= 0 ? cs : big);
    }
    m[w] = m[rh_dtw_clamp(b_len - 1 + r, 0, w - 1)];
  });
  if (cols <= 1) {
    wp.sync();
    return m[w];
  }
  const bool slide_all = b_len >= a_len;  // the band slides every column
  const int q32 = (int)(32LL * b_len / a_len), r32 = (int)(32LL * b_len % a_len);
  // per lane: its column's slot, center, whether the band slid, valid slots
  // [lo, hi), the slot whose dp is the pair's cost (none: INT32_MIN) and
  // a's value; the same of the column it takes next (_n), with that
  // column's floor(c b_len / a_len) as f_n and rem_n; the column's sums and
  // running minimum; the dp it was handed the last L + 1 steps (hist[0]
  // the newest); the next round's rows of b
  VI s, center, inc, lo, hi, oslot, center_n, inc_n, lo_n, hi_n, oslot_n, f_n, rem_n;
  VF ai, a_n, inner, excl, cm, hist[L + 1], stage[L + 2];
  wp.lanes([&](int l) {
    s[l] = kOff;
    center[l] = inc[l] = lo[l] = hi[l] = 0;
    oslot[l] = INT32_MIN;
    ai[l] = inner[l] = excl[l] = 0.0f;
    cm[l] = INFINITY;
    f_n[l] = (int)((long long)(1 + l) * b_len / a_len);
    rem_n[l] = (int)((long long)(1 + l) * b_len % a_len);
    // lane 0's column 1 reads column 0 as handed on before step 0
    RH_DTW_UNROLL
    for (int k = 0; k <= L; ++k)
      hist[k][l] = l == 0 && L - 1 - k >= 0 && L - 1 - k < w ? m[L - 1 - k] : big;
  });
  // b's rows from `base` as a round reads them (clamped to b's row)
  auto load_rows = [&](int base) {
    wp.lanes([&](int l) {
      RH_DTW_UNROLL
      for (int k = 0; k < L + 2; ++k) stage[k][l] = rh_dtw_read(b, base + l + 32 * k, bn);
    });
  };
  auto store_rows = [&](float* buf) {
    wp.lanes([&](int l) {
      RH_DTW_UNROLL
      for (int k = 0; k < L + 2; ++k) buf[l + 32 * k] = stage[k][l];
    });
  };
  int base = rh_dtw_center(1, a_len, b_len) - r;  // round 0's first row
  load_rows(base);
  store_rows(win);
  wp.sync();
  const int steps = L * (cols - 2) + w;
  for (int round = 0; 32 * L * round < steps; ++round) {
    // the columns the lanes take this round
    wp.lanes([&](int l) {
      const int c = 1 + l + 32 * round;
      if (round > 0) {
        f_n[l] += q32;
        rem_n[l] += r32;
        if (rem_n[l] >= a_len) {
          rem_n[l] -= a_len;
          f_n[l] += 1;
        }
      }
      const int cen = c < f_n[l] ? c : f_n[l];
      center_n[l] = cen;
      inc_n[l] = slide_all || rem_n[l] < b_len;
      lo_n[l] = r - cen > r - radius ? r - cen : r - radius;
      hi_n[l] = b_len - cen + r < r + radius + 1 ? b_len - cen + r : r + radius + 1;
      oslot_n[l] = c == cols - 1 ? rh_dtw_clamp(b_len - 1 - cen + r, 0, w - 1) : INT32_MIN;
      a_n[l] = c < cols ? a[c] : 0.0f;
    });
    // the next round's rows: from the first row of lane 1's column this
    // round (its first column still running then)
    const int base_n = wp.bcast(center_n, 1) - r;
    load_rows(base_n);
    const int t0 = 32 * L * round;
    const float* rows = win + (round & 1) * kSpan;  // this round's rows of b
    for (int g = 0; g < 32 && t0 + L * g < steps; ++g) {
      RH_DTW_UNROLL
      for (int k = 0; k < L; ++k) {
        const int t = t0 + L * g + k;
        VF out;
        wp.lanes([&](int l) {
          if (k == 0 && l == g) {  // the lane takes its column this step
            const int c = 1 + l + 32 * round;
            s[l] = c < cols ? 0 : kOff;
            center[l] = center_n[l];
            inc[l] = inc_n[l];
            lo[l] = lo_n[l];
            hi[l] = hi_n[l];
            oslot[l] = oslot_n[l];
            ai[l] = a_n[l];
          }
          const int sl = s[l];
          const bool on = sl >= 0 && sl < w;
          const float cost = fabsf(ai[l] - rows[on ? center[l] + sl - r - base : 0]);
          const float left = inc[l] ? hist[L - 2][l] : hist[L - 1][l];
          const float topleft = inc[l] ? hist[L - 1][l] : hist[L][l];
          const float bm = fminf(fminf(left, topleft) + cost, big);
          const int q = sl & (RH_DTW_BLOCK - 1);
          inner[l] = q == 0 ? cost : inner[l] + cost;
          float cs = inner[l];
          if (N > 1) {  // the blocks before: 0 in a column's first block
            excl[l] = sl == 0 ? 0.0f : excl[l];
            cs = excl[l] + inner[l];
            if (q == RH_DTW_BLOCK - 1) excl[l] = cs;
          }
          cm[l] = fminf(sl == 0 ? INFINITY : cm[l], bm - cs);
          // what the next lane is handed: this slot's dp; BIG off a
          // column, but lane 31 hands on column 0 before its first column
          const float idle = round == 0 && l == 31 && sl < 0 && t + L < w ? m[t + L] : big;
          const float v = sl >= lo[l] && sl < hi[l] ? fminf(cm[l] + cs, big)
                                                    : (on ? big : idle);
          out[l] = v;
          if (sl == oslot[l]) m[w] = v;
          s[l] = sl + 1;
        });
        const VF in = wp.rotate(out);
        wp.lanes([&](int l) {
          RH_DTW_UNROLL
          for (int j = L; j > 0; --j) hist[j][l] = hist[j - 1][l];
          hist[0][l] = in[l];
        });
      }
    }
    wp.sync();  // the round's reads of the buffer it fills next are done
    store_rows(win + ((round + 1) & 1) * kSpan);
    base = base_n;
    wp.sync();
  }
  return m[w];
}
