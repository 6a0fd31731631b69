// Per-slot score and per-anchor step of the chaining DP fill, shared by the
// CUDA kernel (chain_fill.cu) and any host build of the same logic.
//
// The recurrence is the reference's mg_lchain_dp (lchain.c:439-505) without
// the max_skip pruning, exactly as rawhash_tpu/chain/pallas_fill.py computes
// it: for anchor i, score the W = max_iter predecessors in a ring, keep the
// best total (ties to the largest j), then consider the banded
// out-of-window predecessor max_ii.
//
// Without nvcc the header compiles as plain C++ (g++ -ffp-contract=off), so
// the CPU tests can hold this exact code against the plain PyTorch fill.
// Every float operation here must round separately: build the CUDA side
// with --fmad=false and the host side with -ffp-contract=off.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RH_HD __host__ __device__ __forceinline__
#else
#define RH_HD static inline
#endif

#define RH_INT32_MIN (-2147483647 - 1)

struct RhParams {
  int q_span, max_dist_t, max_dist_q, bw, w;  // w = ring size = max_iter
  float pen_gap, pen_skip;
};

// wrap-around int32 arithmetic (defined behaviour on overflow)
RH_HD int rh_sub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
RH_HD int rh_add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }

RH_HD uint32_t rh_f2u(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

RH_HD float rh_u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

// bit-twiddled fast log2 (lchain.c:23-31)
RH_HD float rh_mg_log2(float x) {
  uint32_t z = rh_f2u(x);
  float log_2 = (float)((int)((z >> 23) & 255u) - 128);
  z = (z & ~(255u << 23)) + (127u << 23);
  float zf = rh_u2f(z);
  return log_2 + ((-0.34484843f * zf + 2.02466578f) * zf - 0.67487759f);
}

// score of a predecessor step with distances dd = |dr - dq|, dg = min(dr, dq)
// (compute_score, lchain.c:297-356); the penalty truncates toward zero
RH_HD int rh_score(int dd, int dg, const RhParams& P) {
  int sc = dg < P.q_span ? dg : P.q_span;
  if (dd != 0 || dg > P.q_span) {
    float lin = P.pen_gap * (float)dd + P.pen_skip * (float)dg;
    float log_pen = dd >= 1 ? rh_mg_log2((float)(dd + 1)) : 0.0f;
    sc -= (int)(lin + 0.5f * log_pen);
  }
  return sc;
}

struct RhSlot {
  int total;    // score + f[j], RH_INT32_MIN if j is not an allowed predecessor
  int in_band;  // same target, 0 <= dr <= max_dist_t (counts toward the band)
};

// one ring slot holding predecessor j (j_valid: j >= 0 and j < n_anchors)
RH_HD RhSlot rh_slot(int k_i, int t_i, int q_i, int rk, int rt, int rq, int rf,
                     int j_valid, const RhParams& P) {
  RhSlot s = {RH_INT32_MIN, 0};
  int dr = rh_sub(t_i, rt);
  s.in_band = j_valid && rk == k_i && dr <= P.max_dist_t && dr >= 0;
  if (!s.in_band) return s;
  int dq = rh_sub(q_i, rq);
  if (dq <= 0 || dq > P.max_dist_q || dr == 0 || dr > P.max_dist_q) return s;
  int diff = rh_sub(dr, dq);
  int dd = diff < 0 ? -diff : diff;
  if (dd > P.bw) return s;
  s.total = rh_add(rh_score(dd, dr < dq ? dr : dq, P), rf);
  return s;
}

// the banded max_ii predecessor: index (-1 = none) and its anchor fields
struct RhMii {
  int idx, key, tpos, qpos, f;
};

// What the window scan over the ring yields for anchor i.
struct RhWindow {
  int best, best_j;  // best total and its largest j (best may be INT32_MIN)
  int n_inband;      // in-band slots
  int re_j;          // largest j among in-band slots with the best f (if any)
  int re_key, re_tpos, re_qpos, re_f;  // ring fields of slot re_j
};

// Step for anchor i after the window scan: max_ii refresh and shortcut, then
// the max_ii advance.  Writes f_i and p_i; updates m.
RH_HD void rh_step(int i, int k_i, int t_i, int q_i, const RhWindow& win,
                   RhMii& m, const RhParams& P, int* f_i, int* p_i) {
  int max_f = win.best > P.q_span ? win.best : P.q_span;
  int max_j = win.best > P.q_span ? win.best_j : -1;
  int st = i - win.n_inband;
  int stale = m.idx < 0 || m.key != k_i ||
              rh_sub(t_i, m.tpos) > P.max_dist_t || t_i < m.tpos;
  if (stale) {
    if (win.n_inband > 0) {
      m.idx = win.re_j;
      m.key = win.re_key;
      m.tpos = win.re_tpos;
      m.qpos = win.re_qpos;
      m.f = win.re_f;
    } else {
      m.idx = -1;
    }
  }
  // score against max_ii when it sits before the examined window
  if (m.idx >= 0 && m.idx < st && m.key == k_i) {
    int dq = rh_sub(q_i, m.qpos), dr = rh_sub(t_i, m.tpos);
    if (dq > 0 && dq <= P.max_dist_q && dr > 0 && dr <= P.max_dist_t &&
        dr <= P.max_dist_q) {
      int diff = rh_sub(dr, dq);
      int dd = diff < 0 ? -diff : diff;
      if (dd <= P.bw) {
        int cand = rh_add(rh_score(dd, dr < dq ? dr : dq, P), m.f);
        if (cand > max_f) {
          max_f = cand;
          max_j = m.idx;
        }
      }
    }
  }
  // advance max_ii to i when i dominates (lchain.c:503)
  if (m.idx < 0 || (m.key == k_i && t_i >= m.tpos &&
                    rh_sub(t_i, m.tpos) <= P.max_dist_t && m.f < max_f)) {
    m.idx = i;
    m.key = k_i;
    m.tpos = t_i;
    m.qpos = q_i;
    m.f = max_f;
  }
  *f_i = max_f;
  *p_i = max_j;
}

// absolute anchor index held by ring slot s while anchor i is scored:
// j == s (mod w), i - w <= j < i (negative before the ring has filled)
RH_HD int rh_slot_anchor(int i, int s, int w) {
  int r = (i - 1 - s) % w;
  if (r < 0) r += w;
  return i - 1 - r;
}

// lexicographic (value, j) maximum: ties go to the larger j
RH_HD int rh_better(int v, int j, int best_v, int best_j) {
  return v > best_v || (v == best_v && j > best_j);
}

// Single-thread fill of one read: the order of operations every parallel
// version must reproduce.  ring holds 4*w ints (key, tpos, qpos, f).
RH_HD void rh_fill_read(const int* key, const int* tpos, const int* qpos,
                        int n_anchors, int n, int* f, int* p, int* ring,
                        const RhParams& P) {
  int* rk = ring;
  int* rt = ring + P.w;
  int* rq = ring + 2 * P.w;
  int* rf = ring + 3 * P.w;
  for (int s = 0; s < P.w; ++s) {
    rk[s] = rt[s] = rq[s] = 0;
    rf[s] = RH_INT32_MIN;
  }
  RhMii m = {-1, 0, 0, 0, RH_INT32_MIN};
  int n_a = n_anchors < n ? n_anchors : n;
  for (int i = 0; i < n_a; ++i) {
    RhWindow win = {RH_INT32_MIN, RH_INT32_MIN, 0, RH_INT32_MIN, 0, 0, 0, 0};
    int re_f = RH_INT32_MIN, re_s = 0;
    for (int s = 0; s < P.w; ++s) {
      int j = rh_slot_anchor(i, s, P.w);
      RhSlot r = rh_slot(key[i], tpos[i], qpos[i], rk[s], rt[s], rq[s], rf[s],
                         j >= 0, P);
      if (rh_better(r.total, j, win.best, win.best_j)) {
        win.best = r.total;
        win.best_j = j;
      }
      if (r.in_band) {
        win.n_inband++;
        if (rh_better(rf[s], j, re_f, win.re_j)) {
          re_f = rf[s];
          win.re_j = j;
          re_s = s;
        }
      }
    }
    win.re_key = rk[re_s];
    win.re_tpos = rt[re_s];
    win.re_qpos = rq[re_s];
    win.re_f = rf[re_s];
    rh_step(i, key[i], tpos[i], qpos[i], win, m, P, &f[i], &p[i]);
    int s = i % P.w;
    rk[s] = key[i];
    rt[s] = tpos[i];
    rq[s] = qpos[i];
    rf[s] = f[i];
  }
  for (int i = n_a < 0 ? 0 : n_a; i < n; ++i) {
    f[i] = 0;
    p[i] = -1;
  }
}
