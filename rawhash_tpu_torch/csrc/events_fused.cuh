// The events stage of one chunk row (signal/events.py::detect_events_batch
// on CPU tensors), as two row programs around the peak detector
// (events_peaks.cuh): rh_ev_norm_row from the signal row to the clipped,
// normalised row and both t-statistics, and rh_ev_segments_row from the
// detector's emissions to the row's events.  Shared by the CUDA kernels
// (events_fused.cu, a block a row) and a host build of the same logic
// (events_fused_host.cpp, which the CPU tests build with g++).
//
// A row program is a sequence of phases run by a team (ordered_scan.cuh:
// tm.each(f) runs f(t, nt) on each member, then all wait; here also
// tm.size(), nt, and tm.atomic_add), so the host build runs the kernels'
// own phases with the threads as a loop.  Every float
// operation rounds where the plain version's does: the sums and prefix sums
// in ordered_scan.cuh's order (its functions, on rows staged in its padded
// layouts), a multiply, add, divide or square root rounded once each (the
// rh_f* functions: the _rn intrinsics on the card, plain operators under
// g++'s -ffp-contract=off on the host), and the plain version's `fma`, a
// product and sum in f64 rounded back to f32, the same (rh_fma64: a
// single-rounding fmaf would differ from it where the f64 sum rounds).  So
// every build gives the plain version's events, counts and carry bit for bit.
//
// The segments: the plain version sorts each row by (segment, value) and
// reads each segment's quartiles and kept sum from the sorted row.  The
// segments are the runs of positions between consecutive peaks, so the
// sorted row's segment q sits at [pk[q - 1], pk[q]) (pk the sorted peaks,
// pk[-1] = 0) and only positions before pk[n_ev - 1] are in a segment;
// sorting each segment's values where they lie gives the sorted row, and the
// rest of the row stays zero, as the plain version's keep mask leaves it.
// rh_ev_segments_row sorts a segment of up to RH_EV_SHORT values on one
// thread (insertion, in registers and local memory; D2-like reads' segments
// hold 8.6 values on average, 41 at most), and a longer one on the whole
// block (a bitonic network, through a shared-memory tile where the row lies
// in global memory).
#pragma once

#include <float.h>
#include <stdint.h>

#include "ordered_scan.cuh"

#ifdef __CUDACC__
#define RH_EV_HD __host__ __device__ __forceinline__
#define RH_EV_D __device__ __forceinline__
#else
#define RH_EV_HD static inline
#define RH_EV_D static inline
#endif

// threads a row (a block of the kernels, the host build's loop)
#define RH_EV_THREADS 256
// the words of a row's team scratch (`part`: a word a thread, the scan's
// total, the long segments' count, the next long segment's bounds twice,
// the mean and the std)
#define RH_EV_PART (RH_EV_THREADS + 8)
// the longest segment one thread sorts; and the keys a shared-memory tile
// sorts at a time when the row's keys lie in global memory
#define RH_EV_SHORT 64
#define RH_EV_TILE 8192

// ---- rounding, written out --------------------------------------------------

#ifdef __CUDA_ARCH__
RH_EV_D float rh_fadd(float a, float b) { return __fadd_rn(a, b); }
RH_EV_D float rh_fsub(float a, float b) { return __fsub_rn(a, b); }
RH_EV_D float rh_fmul(float a, float b) { return __fmul_rn(a, b); }
RH_EV_D float rh_fdiv(float a, float b) { return __fdiv_rn(a, b); }
RH_EV_D float rh_fsqrt(float a) { return __fsqrt_rn(a); }
RH_EV_D float rh_frcp(float a) { return __frcp_rn(a); }
// events.py::fma: a * b + c in f64 (the product exact), rounded to f32
RH_EV_D float rh_fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}
RH_EV_D unsigned rh_f2u(float v) { return __float_as_uint(v); }
RH_EV_D float rh_u2f(unsigned u) { return __uint_as_float(u); }
#else
#include <math.h>
#include <string.h>
RH_EV_D float rh_fadd(float a, float b) { return a + b; }
RH_EV_D float rh_fsub(float a, float b) { return a - b; }
RH_EV_D float rh_fmul(float a, float b) { return a * b; }
RH_EV_D float rh_fdiv(float a, float b) { return a / b; }
RH_EV_D float rh_fsqrt(float a) { return sqrtf(a); }
RH_EV_D float rh_frcp(float a) { return 1.0f / a; }
RH_EV_D float rh_fma64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}
RH_EV_D unsigned rh_f2u(float v) {
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}
RH_EV_D float rh_u2f(unsigned u) {
  float v;
  memcpy(&v, &u, 4);
  return v;
}
#endif

// the signal's samples (f32; the kernels add f16)
RH_EV_D float rh_ev_widen(float x) { return x; }

// events.py::_sort_key_f32: f32 values in their total order (-0 before +0)
// as unsigned ints, and back
RH_EV_D unsigned rh_ev_key(float v) {
  const unsigned b = rh_f2u(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
RH_EV_D float rh_ev_unkey(unsigned k) {
  return rh_u2f((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

RH_EV_HD long long rh_ev_round4(long long n) { return (n + 3) & ~3LL; }

RH_EV_HD int rh_ev_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---- the plans: a row's scratch, in 4-byte words ----------------------------

// rh_ev_norm_row's: the signal staged in the sum's padded layout (window k
// at 33 k - front), later the squares' prefix; the clipped row in the
// prefix sum's padded layout (block k at 17 k), later its prefix; the sum's
// and the prefix sum's levels, each with its squares'.
struct RhEvNormPlan {
  RhScanPlan sum, pre;
  int s_len, x_len;
  long long off_x, off_sl, off_pl, words;
};

RH_EV_HD void rh_ev_norm_plan(int l, RhEvNormPlan* p) {
  rh_scan_plan(l, false, true, &p->sum);
  rh_scan_plan(l, true, true, &p->pre);
  p->s_len = rh_lev_at(l - 1, RH_SUM_WINDOW, p->sum.fronts[0]) + 1;
  p->x_len = rh_lev_at(l - 1, RH_SCAN_BLOCK, 0) + 1;
  const long long a = p->s_len > p->x_len ? p->s_len : p->x_len;
  p->off_x = rh_ev_round4(a);
  p->off_sl = p->off_x + rh_ev_round4(p->x_len);
  p->off_pl = p->off_sl + rh_ev_round4(2 * p->sum.lev);
  p->words = p->off_pl + rh_ev_round4(2 * p->pre.lev);
}

// rh_ev_segments_row's: the values' sort keys (rh_ev_key), an int a
// position (the peaks' histogram, then its prefix; later the keep mask's
// prefix), the kept values in the prefix sum's padded layout (later their
// prefix) and its levels, the sorted peaks and each segment's bounds of the
// IQR filter (room for every peak a row can emit, up to e_cap).
struct RhEvSegPlan {
  RhScanPlan pre;
  int x_len, n_pk;
  long long off_g, off_x, off_pl, off_pk, off_lo, off_hi, words;
};

RH_EV_HD void rh_ev_seg_plan(int l, int e_cap, RhEvSegPlan* p) {
  rh_scan_plan(l, true, false, &p->pre);
  p->x_len = rh_lev_at(l - 1, RH_SCAN_BLOCK, 0) + 1;
  p->n_pk = e_cap < 2 * l ? e_cap : 2 * l;
  p->off_g = rh_ev_round4(l);
  p->off_x = p->off_g + rh_ev_round4(l);
  p->off_pl = p->off_x + rh_ev_round4(p->x_len);
  p->off_pk = p->off_pl + rh_ev_round4(p->pre.lev);
  p->off_lo = p->off_pk + rh_ev_round4(p->n_pk);
  p->off_hi = p->off_lo + rh_ev_round4(p->n_pk);
  p->words = p->off_hi + rh_ev_round4(p->n_pk);
}

// Whether a row program's scratch of `words` stays in a block's shared
// memory (else in the workspace's global scratch).
RH_EV_HD bool rh_ev_fits_shared(long long words) {
  return 4 * words <= RH_SCAN_SMEM_MAX;
}

// the t-statistics' windows and their reciprocals, f32(1 / w) as the plain
// version rounds them (the f64 quotient rounded to f32)
struct RhEvParams {
  int w1, w2;
  float rw1, rw2;
};

RH_EV_HD RhEvParams rh_ev_params(int w1, int w2) {
  RhEvParams E = {w1, w2, (float)(1.0 / (double)w1), (float)(1.0 / (double)w2)};
  return E;
}

// ---- shared steps ------------------------------------------------------------

// the [lo, hi) of n items that member t of nt takes in chunked phases
RH_EV_HD void rh_ev_chunk(int n, int t, int nt, int* lo, int* hi) {
  const int c = (n + nt - 1) / nt;
  *lo = t * c < n ? t * c : n;
  *hi = *lo + c < n ? *lo + c : n;
}

// part[0 .. nt) replaced by its exclusive prefix; part[nt] = the total
RH_EV_D void rh_ev_excl_scan(int* part, int nt) {
  int s = 0;
  for (int u = 0; u < nt; ++u) {
    const int v = part[u];
    part[u] = s;
    s += v;
  }
  part[nt] = s;
}

// a[0 .. n) replaced by its inclusive prefix (ints), part: nt + 1 ints
template <class Team>
RH_EV_D void rh_ev_scan_ints(Team& tm, int* a, int n, int* part) {
  tm.each([&](int t, int nt) {
    int lo, hi, s = 0;
    rh_ev_chunk(n, t, nt, &lo, &hi);
    for (int i = lo; i < hi; i += 8) {  // 8 loads in flight, then the adds
      int v[8];
      for (int e = 0; e < 8; ++e) v[e] = i + e < hi ? a[i + e] : 0;
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        if (i + e < hi) a[i + e] = s;
      }
    }
    part[t] = s;
  });
  tm.each([&](int t, int nt) {
    if (t == 0) rh_ev_excl_scan(part, nt);
  });
  tm.each([&](int t, int nt) {
    int lo, hi;
    rh_ev_chunk(n, t, nt, &lo, &hi);
    const int off = part[t];
    for (int i = lo; i < hi; ++i) a[i] += off;
  });
}

// k[0 .. n) sorted ascending: a bitonic network over the next power of two
// in its form with ascending comparators only (each merge's first step
// pairs i with its mirror in the block), so the positions past n act as
// keys larger than all and their comparisons are left out
template <class Team>
RH_EV_D void rh_ev_sort(Team& tm, unsigned* k, int n) {
  const int np = rh_ev_pow2(n);
  for (int s = 2; s <= np; s <<= 1)
    for (int j = s >> 1; j > 0; j >>= 1)
      tm.each([&](int t, int nt) {
        for (int i = t; i < n; i += nt) {
          const int o = j == s >> 1 ? i ^ (s - 1) : i ^ j;
          if (o <= i || o >= n) continue;
          const unsigned a = k[i], b = k[o];
          if (a > b) {
            k[i] = b;
            k[o] = a;
          }
        }
      });
}

// k[0 .. n) sorted ascending on one thread (n <= RH_EV_SHORT): insertion
// in a local copy
RH_EV_D void rh_ev_sort_short(unsigned* k, int n) {
  unsigned v[RH_EV_SHORT];
  for (int i = 0; i < n; ++i) {
    const unsigned x = k[i];
    int j = i;
    for (; j > 0 && v[j - 1] > x; --j) v[j] = v[j - 1];
    v[j] = x;
  }
  for (int i = 0; i < n; ++i) k[i] = v[i];
}

// value j of a prefix sum with its leading zero, the sums held in the
// prefix sum's padded layout at x
RH_EV_D float rh_ev_pre(const float* x, int j) {
  return j ? x[rh_lev_at(j - 1, RH_SCAN_BLOCK, 0)] : 0.0f;
}

// events.py::_tstat at position i (prefix and its squares' in x and q):
// the t-statistic of the two w-windows around i, 0 outside [w, n_sig - w]
RH_EV_D float rh_ev_tstat(const float* x, const float* q, int i, int l,
                          int n_sig, int w, float rw) {
  if (!(i >= w && i <= n_sig - w && n_sig >= 2 * w)) return 0.0f;
  const int im = i - w, ip = i + w < l ? i + w : l;
  const float p_i = rh_ev_pre(x, i), q_i = rh_ev_pre(q, i);
  const float sum1 = i > w ? rh_fsub(p_i, rh_ev_pre(x, im)) : p_i;
  const float sumsq1 = i > w ? rh_fsub(q_i, rh_ev_pre(q, im)) : q_i;
  const float sum2 = rh_fsub(rh_ev_pre(x, ip), p_i);
  const float sumsq2 = rh_fsub(rh_ev_pre(q, ip), q_i);
  const float mean1 = rh_fmul(sum1, rw), mean2 = rh_fmul(sum2, rw);
  float var = rh_fma64(sumsq1, rw, -rh_fmul(mean1, mean1));
  var = rh_fma64(sumsq2, rw, var);
  var = rh_fma64(-mean2, mean2, var);
  var = rh_fmul(var, rw);
  var = var < FLT_MIN ? FLT_MIN : var;  // clamp_min: NaN stays NaN
  return rh_fmul(fabsf(rh_fsub(mean2, mean1)), rh_frcp(rh_fsqrt(var)));
}

// ---- the first program: statistics, normalisation, clip, t-statistics -------

// One row: sig (slen valid samples of l; the rest masked to 0), the carry
// in (c_sum, c_sq, c_n) -> the carry out (*o_sum, *o_sq, *o_n), normc (the
// clipped normalised samples compacted to the front, zeros after them),
// *o_nsig (their count) and both t-statistics ts1, ts2 [l].  r: the row's
// scratch (rh_ev_norm_plan's words); part: the team's RH_EV_PART words.
template <class Team, class In>
RH_EV_D void rh_ev_norm_row(Team& tm, const RhEvNormPlan& P, RhEvParams E,
                            const In* sig, int l, int slen, float c_sum,
                            float c_sq, int c_n, float* r, int* part,
                            float* normc, float* ts1, float* ts2, float* o_sum,
                            float* o_sq, int* o_n, int* o_nsig) {
  const RhScanPlan &S = P.sum, &Q = P.pre;
  const int f0 = S.fronts[0];
  float* s = r;            // the signal, then the squares' prefix
  float* x = r + P.off_x;  // the clipped row, then its prefix
  float* sl = r + P.off_sl;
  float* sl2 = sl + S.lev;
  float* pl = r + P.off_pl;
  float* pl2 = pl + Q.lev;
  float* mean_std = reinterpret_cast<float*>(part + RH_EV_THREADS + 4);

  // the masked signal (events.py: sig_m)
  tm.each([&](int t, int nt) {
    for (int i = t; i < l; i += nt)
      s[rh_lev_at(i, RH_SUM_WINDOW, f0)] = i < slen ? rh_ev_widen(sig[i]) : 0.0f;
  });
  // its sum and its squares' (ordered_sum_plain): level 1, the levels
  // above, the top; then the carry, the mean and the std on member 0
  if (S.top) {
    tm.each([&](int t, int nt) {
      for (int k = t; k < S.sizes[1]; k += nt) {
        const int at = rh_lev_at(k, RH_SUM_WINDOW, S.fronts[1]);
        sl[at] = rh_sum_window(s + k, l, f0, k);
        sl2[at] = rh_sum_window(s + k, l, f0, k, true);
      }
    });
    rh_sum_levels_team(tm, sl, sl2, S);
  }
  tm.each([&](int t, int) {
    if (t) return;
    const float sum = S.top ? rh_sum_top(sl + S.offs[S.top], S.sizes[S.top], false)
                            : rh_sum_top(s, l, false);
    const float sum_sq = S.top ? rh_sum_top(sl2 + S.offs[S.top], S.sizes[S.top], false)
                               : rh_sum_top(s, l, true);
    const float new_sum = rh_fadd(c_sum, sum), new_sq = rh_fadd(c_sq, sum_sq);
    const int new_n = (int)((unsigned)c_n + (unsigned)slen);
    const float nf = (float)(new_n < 1 ? 1 : new_n);
    const float mean = rh_fdiv(new_sum, nf);
    float var = rh_fma64(-mean, mean, rh_fdiv(new_sq, nf));
    var = var < 0.0f ? 0.0f : var;  // clamp_min: NaN stays NaN
    const float sd = rh_fsqrt(var);
    *o_sum = new_sum;
    *o_sq = new_sq;
    *o_n = new_n;
    mean_std[0] = mean;
    mean_std[1] = sd > 0.0f ? sd : 1.0f;
  });

  // the clip and the stable compaction (dense_compact): each member counts
  // the kept samples of its chunk, member 0 scans the counts, each member
  // writes its chunk's samples at its offset; zeros past the count
  const float mean = mean_std[0], sd = mean_std[1];
  auto norm_at = [&](int i, float* z) {
    *z = rh_fdiv(rh_fsub(s[rh_lev_at(i, RH_SUM_WINDOW, f0)], mean), sd);
    return i < slen && *z < 3.0f && *z > -3.0f;
  };
  tm.each([&](int t, int nt) {
    int lo, hi, c = 0;
    float z;
    rh_ev_chunk(l, t, nt, &lo, &hi);
    for (int i = lo; i < hi; ++i) c += norm_at(i, &z);
    part[t] = c;
  });
  tm.each([&](int t, int nt) {
    if (t == 0) rh_ev_excl_scan(part, nt);
  });
  tm.each([&](int t, int nt) {
    int lo, hi, o = part[t];
    float z;
    rh_ev_chunk(l, t, nt, &lo, &hi);
    for (int i = lo; i < hi; ++i)
      if (norm_at(i, &z)) {
        x[rh_lev_at(o, RH_SCAN_BLOCK, 0)] = z;
        normc[o++] = z;
      }
    for (int i = part[nt] + t; i < l; i += nt) {
      x[rh_lev_at(i, RH_SCAN_BLOCK, 0)] = 0.0f;
      normc[i] = 0.0f;
    }
  });
  const int n_sig = part[tm.size()];

  // the prefix sums of the row and of its squares with their leading zero
  // (ordered_cumsum_plain): the blocks' totals, the levels above, each
  // block's running sums plus the blocks' prefix before it (the row's in
  // place, the squares' into s)
  if (Q.top) {
    tm.each([&](int t, int nt) {
      for (int k = t; k < Q.units; k += nt) {
        const int at = rh_lev_at(k, RH_SCAN_BLOCK, 0);
        pl[at] = rh_cumsum_block_total(x + k, l, k);
        pl2[at] = rh_cumsum_block_total(x + k, l, k, true);
      }
    });
    rh_prefix_levels_team(tm, pl, pl2, Q);
  }
  tm.each([&](int t, int nt) {
    for (int k = t; k < Q.units; k += nt) {
      const int pre = rh_lev_at(k - 1, RH_SCAN_BLOCK, 0);
      rh_cumsum_block_out(x + k, l, k, k ? pl[pre] : 0.0f, x + k,
                          k ? pl2[pre] : 0.0f, s + k);
    }
  });
  // both t-statistics
  tm.each([&](int t, int nt) {
    if (t == 0) *o_nsig = n_sig;
    for (int i = t; i < l; i += nt) {
      ts1[i] = rh_ev_tstat(x, s, i, l, n_sig, E.w1, E.rw1);
      ts2[i] = rh_ev_tstat(x, s, i, l, n_sig, E.w2, E.rw2);
    }
  });
}

// ---- the second program: segments, IQR filter, means ------------------------

// One row: the detector's emissions em [2 l] (events_peaks.cuh's order),
// the clipped row normc and its count n_sig -> the row's events ev [e_cap]
// and *o_nev (events.py::_segment_events).  r: the row's scratch
// (rh_ev_seg_plan's words); part: the team's RH_EV_PART words; tile:
// RH_EV_TILE words of shared memory where r lies in global memory, else
// null.
template <class Team>
RH_EV_D void rh_ev_segments_row(Team& tm, const RhEvSegPlan& P, const int* em,
                                const float* normc, int n_sig, int l, int e_cap,
                                float* r, int* part, unsigned* tile, float* ev,
                                int* o_nev) {
  const RhScanPlan& Q = P.pre;
  unsigned* key = reinterpret_cast<unsigned*>(r);
  int* g = reinterpret_cast<int*>(r + P.off_g);
  float* x = r + P.off_x;
  float* pl = r + P.off_pl;
  int* pk = reinterpret_cast<int*>(r + P.off_pk);
  float* lo = r + P.off_lo;
  float* hi = r + P.off_hi;

  // seg[p], the emitted peaks (0 < peak < n_sig, counted with their
  // multiplicity) at or before p: their histogram, then its prefix
  tm.each([&](int t, int nt) {
    for (int i = t; i < l; i += nt) g[i] = 0;
  });
  tm.each([&](int t, int nt) {
    for (int j = t; j < 2 * l; j += nt) {
      const int e = em[j];
      if (e > 0 && e < n_sig) tm.atomic_add(g + e, 1);
    }
  });
  rh_ev_scan_ints(tm, g, l, part);
  const int n_ev = g[l - 1] < e_cap ? g[l - 1] : e_cap;
  // the sorted peaks: peak q at the position where seg passes q
  tm.each([&](int t, int nt) {
    for (int p = t; p < l; p += nt) {
      const int q1 = g[p] < n_ev ? g[p] : n_ev;
      for (int q = p ? g[p - 1] : 0; q < q1; ++q) pk[q] = p;
    }
  });
  // the values of the positions in a segment, [0, m), as sort keys, each
  // segment sorted: the short ones a thread each (counting the long ones),
  // then the long ones one at a time on the block
  const int m = n_ev ? pk[n_ev - 1] : 0;
  int* n_long = part + RH_EV_THREADS + 1;
  tm.each([&](int t, int nt) {
    if (t == 0) *n_long = 0;
    for (int p = t; p < m; p += nt) key[p] = rh_ev_key(normc[p]);
  });
  tm.each([&](int t, int nt) {
    for (int q = t; q < n_ev; q += nt) {
      const int st = q ? pk[q - 1] : 0, len = pk[q] - st;
      if (len <= RH_EV_SHORT) rh_ev_sort_short(key + st, len);
      else tm.atomic_add(n_long, 1);
    }
  });
  int* next = part + RH_EV_THREADS + 2;  // a long segment's bounds, two slots
  for (int q = 0, w = 0, left = *n_long; left; --left, w ^= 1) {
    tm.each([&](int t, int) {  // member 0 finds the next one from segment q
      if (t) return;
      while (pk[q] - (q ? pk[q - 1] : 0) <= RH_EV_SHORT) ++q;
      next[2 * w] = q ? pk[q - 1] : 0;
      next[2 * w + 1] = pk[q];
      ++q;
    });
    const int st = next[2 * w], n = next[2 * w + 1] - st;
    if (tile && n <= RH_EV_TILE) {
      tm.each([&](int t, int nt) {
        for (int i = t; i < n; i += nt) tile[i] = key[st + i];
      });
      rh_ev_sort(tm, tile, n);
      tm.each([&](int t, int nt) {
        for (int i = t; i < n; i += nt) key[st + i] = tile[i];
      });
    } else {
      rh_ev_sort(tm, key + st, n);
    }
  }
  // each segment's quartiles (ranks len // 4 and 3 len // 4) and the IQR
  // filter's bounds
  tm.each([&](int t, int nt) {
    for (int q = t; q < n_ev; q += nt) {
      const int st = q ? pk[q - 1] : 0, len = pk[q] - st;
      if (!len) continue;  // no value of the row reads its bounds
      const float q1 = rh_ev_unkey(key[st + len / 4]);
      const float q3 = rh_ev_unkey(key[st + 3 * len / 4]);
      const float iqr = rh_fsub(q3, q1);
      lo[q] = rh_fsub(q1, iqr);
      hi[q] = rh_fadd(q3, iqr);
    }
  });
  // the kept values (zero elsewhere) and the keep mask
  tm.each([&](int t, int nt) {
    for (int i = t; i < l; i += nt) {
      bool keep = false;
      float v = 0.0f;
      if (i < m) {  // position i's segment, g[i], and its sorted value
        const int q = g[i];
        v = rh_ev_unkey(key[i]);
        keep = v >= lo[q] && v <= hi[q];
      }
      x[rh_lev_at(i, RH_SCAN_BLOCK, 0)] = keep ? v : 0.0f;
      g[i] = keep;
    }
  });
  // their prefix sum with its leading zero (ordered_cumsum_plain), and the
  // mask's
  if (Q.top) {
    tm.each([&](int t, int nt) {
      for (int k = t; k < Q.units; k += nt)
        pl[rh_lev_at(k, RH_SCAN_BLOCK, 0)] = rh_cumsum_block_total(x + k, l, k);
    });
    rh_prefix_levels_team(tm, pl, (float*)nullptr, Q);
  }
  tm.each([&](int t, int nt) {
    for (int k = t; k < Q.units; k += nt)
      rh_cumsum_block_out(x + k, l, k,
                          k ? pl[rh_lev_at(k - 1, RH_SCAN_BLOCK, 0)] : 0.0f, x + k);
  });
  rh_ev_scan_ints(tm, g, l, part);
  // each segment's mean of its kept values
  tm.each([&](int t, int nt) {
    if (t == 0) *o_nev = n_ev;
    for (int q = t; q < e_cap; q += nt) {
      float e = 0.0f;
      if (q < n_ev) {
        const int st = q ? pk[q - 1] : 0, en = pk[q];
        const int cnt = (en ? g[en - 1] : 0) - (st ? g[st - 1] : 0);
        const float sum = rh_fsub(rh_ev_pre(x, en), rh_ev_pre(x, st));
        e = cnt > 0 ? rh_fdiv(sum, (float)cnt) : 0.0f;
      }
      ev[q] = e;
    }
  });
}
