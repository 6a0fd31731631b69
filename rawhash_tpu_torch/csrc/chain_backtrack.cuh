// The greedy all-chains backtrack of one read (reference: mg_chain_backtrack,
// lchain.c:95-194), in two forms that give the same results bit for bit:
//
//   - rh_backtrack_read: the serial algorithm, one candidate after another.
//     It is the specification the rounds are held to, and it counts the
//     work a read needs (RhBtWork) for the kernel's bound;
//   - rh_backtrack_rounds: the same algorithm as csrc/chain_backtrack.cu
//     runs it, 32 candidates a round on the 32 lanes of a warp.  It is a
//     template over the warp: RhDevWarp runs it on the card with warp
//     intrinsics, RhHostWarp on the host with the lanes as a loop, so the
//     tests build it with g++ (csrc/chain_backtrack_host.cpp).
//
// Both compute what the reference package's lockstep backtrack
// (rawhash_tpu/chain/backtrack_device.py::backtrack_batch) computes, plus
// the chain statistics of its chain-stat kernel
// (rawhash_tpu/chain/backtrack_pallas_big.py):
//   - candidates are visited from the top of the (f, idx) ascending order
//     until f < min_sc; a claimed candidate is skipped;
//   - walk A (mg_chain_bk_end, lchain.c:47-75) follows p from the candidate
//     to the score peak max_s at end_i; it stops at a drop of more than
//     max_drop, at the root, or at a claimed anchor.  Visit stamps are not
//     needed: p[i] < i, so a walk never meets a node twice;
//   - the chain is accepted before it is claimed: its score is max_s and its
//     anchor count the step index of the last improvement (cbest), so v and
//     the chain rows are appended in place and never rolled back;
//   - the claim walk marks every anchor from the candidate down to end_i
//     (rejected chains keep their marks, lchain.c semantics) and, for an
//     accepted chain that fits k_cap, writes v and sums the fuzzy lengths
//     over the pairs (p[i], i) with p[i] != end_i (mm_cal_fuzzy_len,
//     hit.c:10-40), modulo 2^32.  An accepted chain that does not fit counts
//     in ovf.
//
// The rounds: lane l takes the candidate k - l; the lanes whose candidate is
// not claimed follow p read-only up to `depth` steps and stage each step's
// node and score (a row of the staging buffer), stopping at the drop break,
// the root, a node claimed at the start of the round, or the depth; a lane
// whose staged walk stopped by itself and is accepted also gathers tpos and
// qpos of the nodes it would keep.  Then the candidates are resolved in
// order: one claimed by an earlier candidate of the round is skipped; one
// whose staged nodes are all still unclaimed and whose walk stopped by
// itself keeps its staged result, and its own lane claims and writes the
// chain; otherwise the whole warp cuts the staged walk at its first node
// claimed now (claims only grow, so every stop but "claimed" is fixed by p
// and f alone, and the step that meets the claimed node is scored), takes
// max_s / end_i / cbest as the prefix values at the cut (a warp max, then
// the first step holding it), goes on serially where the walk reached the
// depth, and runs the claim walk 32 nodes a chunk, one a lane.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RH_BT_FN __device__ inline
#else
#define RH_BT_FN inline
#endif

struct RhBtParams {
  int n;         // anchor width of a row
  int k_cap;     // chain rows per read
  int min_cnt;   // min_num_anchors
  int min_sc;    // min_chaining_score
  int max_drop;  // bw
  int q_span;    // k + e - 1
};

struct RhBtCounts {
  int n_u, n_v, ovf;
};

// The work a read needs, counted by rh_backtrack_read: candidates visited
// (f >= min_sc), of them skipped as claimed, walk-A steps, claim steps
// (anchors claimed), kept chains and v writes.
struct RhBtWork {
  long long candidates, skipped, walk_steps, claim_steps, kept, v_writes;
};

// The staging buffer's rows: `depth` steps of a lane's walk, padded to an
// odd stride so that a lane a row and a lane a step both hit 32 banks.
RH_BT_FN int rh_bt_stride(int depth) { return depth + 1; }

RH_BT_FN bool rh_claimed(const uint32_t* claimed, int j) {
  return (claimed[j >> 5] >> (j & 31)) & 1u;
}

RH_BT_FN int rh_ffs(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(x);
#else
  return __builtin_ffs(x);
#endif
}

// The state of walk A after its last scored step.
struct RhBtWalk {
  int max_s, end_i, cbest;
};

// Walk A from node i, whose predecessor is scored as step `step` (1 at the
// candidate), on from state w; p[ni] is loaded with f[ni], one dependent
// load a step.  Returns the steps taken.
RH_BT_FN int rh_bt_walk(int i, int step, int zsc, const int* f, const int* p,
                        const uint32_t* claimed, int max_drop, RhBtWalk* w) {
  int ni = p[i], taken = 0;
  for (;; ++step) {
    const int fn = ni >= 0 ? f[ni] : 0;
    const int nn = ni >= 0 ? p[ni] : -1;
    const int s = ni < 0 ? zsc : zsc - fn;
    const bool better = s > w->max_s;
    const bool brk = !better && w->max_s - s > max_drop;
    ++taken;
    if (better) {
      w->max_s = s;
      w->end_i = ni;
      w->cbest = step;
    }
    if (brk || ni < 0 || rh_claimed(claimed, ni)) break;
    ni = nn;
  }
  return taken;
}

// The fuzzy-length terms of the pair (a, b) of consecutive claimed anchors
// (mm_cal_fuzzy_len, hit.c:10-40), added modulo 2^32.
RH_BT_FN void rh_bt_fuzzy(int tp_a, int qp_a, int tp_b, int qp_b, int q_span,
                          uint32_t* ml, uint32_t* bl) {
  const int tl = tp_a - tp_b, ql = qp_a - qp_b;
  const int mn = tl < ql ? tl : ql, mx = tl < ql ? ql : tl;
  *ml += (uint32_t)(tl > q_span && ql > q_span ? q_span : mn) + (uint32_t)mn;
  *bl += (uint32_t)mx;
}

// One read, serially.  zf/zi: the candidate order ((f, idx) ascending, pads
// first with f = INT32_MIN) of width P.n; f, p, tpos, qpos: the read's rows;
// claimed: n bits, zero on entry.  v [n] and the six chain rows [k_cap] are
// written only below the returned n_v / n_u.  work, if not null, gains the
// read's work.
RH_BT_FN RhBtCounts rh_backtrack_read(
    const int* zf, const int* zi, const int* f, const int* p, const int* tpos,
    const int* qpos, uint32_t* claimed, int* v, int* u_sc, int* u_cnt,
    int* u_ml, int* u_bl, int* u_lo, int* u_hi, RhBtParams P,
    RhBtWork* work) {
  RhBtCounts c = {0, 0, 0};
  RhBtWork wk = {0, 0, 0, 0, 0, 0};
  for (int k = P.n - 1; k >= 0; --k) {
    const int zsc = zf[k];
    if (zsc < P.min_sc) break;
    const int idx = zi[k];
    ++wk.candidates;
    if (rh_claimed(claimed, idx)) {
      ++wk.skipped;
      continue;
    }
    RhBtWalk w = {0, idx, 0};
    wk.walk_steps += rh_bt_walk(idx, 1, zsc, f, p, claimed, P.max_drop, &w);
    const bool accept = w.max_s >= P.min_sc && w.cbest > 0 && w.cbest >= P.min_cnt;
    const bool keep = accept && c.n_u < P.k_cap;

    // claim walk: candidate -> end_i (exclusive), claim-ordered
    uint32_t ml = P.q_span, bl = P.q_span;
    int lo = idx, m = 0;
    int tp = keep ? tpos[idx] : 0, qp = keep ? qpos[idx] : 0;
    for (int j = idx; j != w.end_i; ++m) {
      claimed[j >> 5] |= 1u << (j & 31);
      const int j2 = p[j];
      if (keep) {
        v[c.n_v + m] = j;
        if (j2 != w.end_i) {
          const int tp2 = tpos[j2], qp2 = qpos[j2];
          rh_bt_fuzzy(tp, qp, tp2, qp2, P.q_span, &ml, &bl);
          tp = tp2;
          qp = qp2;
        }
      }
      lo = j;
      j = j2;
    }
    wk.claim_steps += m;
    if (keep) {
      u_sc[c.n_u] = w.max_s;
      u_cnt[c.n_u] = w.cbest;
      u_ml[c.n_u] = (int)ml;
      u_bl[c.n_u] = (int)bl;
      u_lo[c.n_u] = lo;
      u_hi[c.n_u] = idx;
      ++c.n_u;
      c.n_v += w.cbest;
    } else if (accept) {
      ++c.ovf;
    }
  }
  if (work) {
    wk.kept = c.n_u;
    wk.v_writes = c.n_v;
    work->candidates += wk.candidates;
    work->skipped += wk.skipped;
    work->walk_steps += wk.walk_steps;
    work->claim_steps += wk.claim_steps;
    work->kept += wk.kept;
    work->v_writes += wk.v_writes;
  }
  return c;
}

// ---- the rounds -----------------------------------------------------------

// A warp on the host: 32 lanes as a loop, lane values as arrays.
struct RhHostWarp {
  template <class T>
  struct V {
    T v[32] = {};
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  template <class F>
  void lanes(F fn) const {
    for (int l = 0; l < 32; ++l) fn(l);
  }
  uint32_t ballot(const V<bool>& x) const {
    uint32_t m = 0;
    for (int l = 0; l < 32; ++l) m |= (uint32_t)x[l] << l;
    return m;
  }
  int max(const V<int>& x) const {
    int m = x[0];
    for (int l = 1; l < 32; ++l) m = x[l] > m ? x[l] : m;
    return m;
  }
  uint32_t sum(const V<uint32_t>& x) const {
    uint32_t s = 0;
    for (int l = 0; l < 32; ++l) s += x[l];
    return s;
  }
  template <class T>
  T shfl(const V<T>& x, int src) const { return x[src]; }
  // lane l gets lane l - 1's value; lane 0 its own
  template <class T>
  V<T> shfl_up(const V<T>& x) const {
    V<T> y;
    for (int l = 0; l < 32; ++l) y[l] = x[l ? l - 1 : 0];
    return y;
  }
  void set_bit(uint32_t* m, int j) const { m[j >> 5] |= 1u << (j & 31); }
  void sync() const {}
};

#if defined(__CUDACC__)
// A warp on the card: one lane's value in a register, the intrinsics.
struct RhDevWarp {
  static constexpr uint32_t kAll = 0xffffffffu;
  template <class T>
  struct V {
    T v;
    __device__ T& operator[](int) { return v; }
    __device__ const T& operator[](int) const { return v; }
  };
  template <class F>
  __device__ void lanes(F fn) const { fn((int)(threadIdx.x & 31)); }
  __device__ uint32_t ballot(const V<bool>& x) const { return __ballot_sync(kAll, x.v); }
  __device__ int max(const V<int>& x) const { return __reduce_max_sync(kAll, x.v); }
  __device__ uint32_t sum(const V<uint32_t>& x) const { return __reduce_add_sync(kAll, x.v); }
  template <class T>
  __device__ T shfl(const V<T>& x, int src) const { return __shfl_sync(kAll, x.v, src); }
  template <class T>
  __device__ V<T> shfl_up(const V<T>& x) const { return {__shfl_up_sync(kAll, x.v, 1)}; }
  __device__ void set_bit(uint32_t* m, int j) const { atomicOr(m + (j >> 5), 1u << (j & 31)); }
  __device__ void sync() const { __syncwarp(); }
};
#endif

// One read's rows for the rounds.  The candidates are zf/zi[k_lo, k_hi),
// visited from the top.
struct RhBtRow {
  const int *zf, *zi;
  int k_lo, k_hi;
  const int *f, *p, *tpos, *qpos;
  int *v, *u_sc, *u_cnt, *u_ml, *u_bl, *u_lo, *u_hi;
};

// The staging buffer: four planes of 32 rows, rh_bt_stride(depth) slots a
// row.  Row l holds lane l's staged walk: step j's node (ni) and score (s)
// and, where the staged walk is accepted, tpos and qpos of its nodes
// 0 .. cbest - 1 (tp, qp; node 0 is the candidate, node g step g - 1's).
struct RhBtStage {
  int *ni, *s, *tp, *qp;
};

// A lane's staged walk: up to `depth` steps of walk A from idx, read-only,
// each step's node in sni and score in ss; *w is walk A's state as if the
// walk ended there.  Returns the steps staged, and in *more whether the
// walk reached the depth without stopping.
RH_BT_FN int rh_bt_stage(int idx, int zsc, const int* f, const int* p,
                         const uint32_t* claimed, int depth, int max_drop,
                         int* sni, int* ss, RhBtWalk* w, int* more) {
  *w = {0, idx, 0};
  int ni = depth > 0 ? p[idx] : -1;
  for (int j = 0; j < depth; ++j) {
    const int fn = ni >= 0 ? f[ni] : 0;
    const int nn = ni >= 0 ? p[ni] : -1;
    const int s = ni < 0 ? zsc : zsc - fn;
    sni[j] = ni;
    ss[j] = s;
    const bool better = s > w->max_s;
    const bool brk = !better && w->max_s - s > max_drop;
    if (better) *w = {s, ni, j + 1};
    if (brk || ni < 0 || rh_claimed(claimed, ni)) {
      *more = 0;
      return j + 1;
    }
    ni = nn;
  }
  *more = 1;
  return depth;
}

// tpos and qpos of nodes 0 .. cnt - 1 of a staged walk into stp / sqp,
// the loads of four nodes in flight at once.
RH_BT_FN void rh_bt_gather(int idx, const int* sni, int cnt, const int* tpos,
                           const int* qpos, int* stp, int* sqp) {
  for (int g = 0; g < cnt; g += 4) {
    int nd[4], t[4], q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      nd[u] = g + u < cnt && g + u > 0 ? sni[g + u - 1] : idx;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      t[u] = tpos[nd[u]];
      q[u] = qpos[nd[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g + u < cnt) {
        stp[g + u] = t[u];
        sqp[g + u] = q[u];
      }
    }
  }
}

// One read in rounds of 32 candidates on warp w.  claimed: bits for every
// anchor a walk can reach, zero on entry; st: the staging buffer (unused at
// depth 0); 0 <= depth <= 32.
template <class W>
RH_BT_FN RhBtCounts rh_backtrack_rounds(const W& w, const RhBtRow& R,
                                        uint32_t* claimed, RhBtStage st,
                                        int depth, RhBtParams P) {
  using VI = typename W::template V<int>;
  using VB = typename W::template V<bool>;
  using VU = typename W::template V<uint32_t>;
  const int stride = rh_bt_stride(depth);
  RhBtCounts c = {0, 0, 0};
  VI idx, zsc;  // the round's candidates, loaded a round ahead
  w.lanes([&](int l) {
    const int k = R.k_hi - 1 - l;
    idx[l] = k >= R.k_lo ? R.zi[k] : 0;
    zsc[l] = k >= R.k_lo ? R.zf[k] : 0;
  });
  for (int top = R.k_hi - 1; top >= R.k_lo; top -= 32) {
    // stage: lane l walks candidate top - l if it is not claimed, and
    // gathers tpos/qpos of the nodes an accepted chain would keep
    VI len, more, t_max, t_end, t_cb, n_idx, n_zsc;
    VB fresh;
    w.lanes([&](int l) {
      fresh[l] = top - l >= R.k_lo && !rh_claimed(claimed, idx[l]);
      const int k = top - 32 - l;  // the next round's candidate
      n_idx[l] = k >= R.k_lo ? R.zi[k] : 0;
      n_zsc[l] = k >= R.k_lo ? R.zf[k] : 0;
      len[l] = 0;
      more[l] = 1;
      t_max[l] = t_end[l] = t_cb[l] = 0;
      if (fresh[l]) {
        int* sni = st.ni + l * stride;
        RhBtWalk wt;
        len[l] = rh_bt_stage(idx[l], zsc[l], R.f, R.p, claimed, depth,
                             P.max_drop, sni, st.s + l * stride, &wt, &more[l]);
        t_max[l] = wt.max_s;
        t_end[l] = wt.end_i;
        t_cb[l] = wt.cbest;
        if (!more[l] && wt.max_s >= P.min_sc && wt.cbest >= P.min_cnt)
          rh_bt_gather(idx[l], sni, wt.cbest, R.tpos, R.qpos,
                       st.tp + l * stride, st.qp + l * stride);
      }
    });
    w.sync();

    // resolve in order
    for (uint32_t todo = w.ballot(fresh); todo; todo &= todo - 1) {
      const int l = rh_ffs(todo) - 1;
      const int cidx = w.shfl(idx, l);
      if (rh_claimed(claimed, cidx)) continue;  // claimed earlier this round
      const int clen = w.shfl(len, l), czsc = w.shfl(zsc, l);
      const int* rni = st.ni + l * stride;
      const int* rs = st.s + l * stride;

      // walk A: the staged walk cut at its first node claimed now
      VI ni, s;
      VB hit;
      w.lanes([&](int j) {
        const bool in = j < clen;
        ni[j] = in ? rni[j] : -1;
        s[j] = in ? rs[j] : 0;
        hit[j] = in && ni[j] >= 0 && rh_claimed(claimed, ni[j]);
      });
      const uint32_t hits = w.ballot(hit);
      const int cmore = w.shfl(more, l);
      if (!hits && !cmore) {
        // nothing claimed on the staged walk since the round began and it
        // stopped by itself: the staged result stands; lane l claims its
        // nodes, all staged, and writes the chain
        const RhBtWalk wa = {w.shfl(t_max, l), w.shfl(t_end, l), w.shfl(t_cb, l)};
        const bool accept = wa.max_s >= P.min_sc && wa.cbest > 0 && wa.cbest >= P.min_cnt;
        const bool keep = accept && c.n_u < P.k_cap;
        const int at_u = c.n_u, at_v = c.n_v;
        w.lanes([&](int t) {
          if (t != l) return;
          const int* tp = st.tp + l * stride;
          const int* qp = st.qp + l * stride;
          uint32_t ml = P.q_span, bl = P.q_span;
          int node = cidx;
          for (int g = 0; g < wa.cbest; ++g) {
            node = g ? rni[g - 1] : cidx;
            w.set_bit(claimed, node);
            if (keep) {
              R.v[at_v + g] = node;
              if (g) rh_bt_fuzzy(tp[g - 1], qp[g - 1], tp[g], qp[g], P.q_span, &ml, &bl);
            }
          }
          if (keep) {
            R.u_sc[at_u] = wa.max_s;
            R.u_cnt[at_u] = wa.cbest;
            R.u_ml[at_u] = (int)ml;
            R.u_bl[at_u] = (int)bl;
            R.u_lo[at_u] = node;
            R.u_hi[at_u] = cidx;
          }
        });
        w.sync();
        if (keep) {
          ++c.n_u;
          c.n_v += wa.cbest;
        } else if (accept) {
          ++c.ovf;
        }
        continue;
      }

      const int last = hits ? rh_ffs(hits) - 1 : clen - 1;
      VI su;
      w.lanes([&](int j) { su[j] = j <= last && s[j] > 0 ? s[j] : 0; });
      RhBtWalk wa = {w.max(su), cidx, 0};
      if (wa.max_s > 0) {
        VB at;
        w.lanes([&](int j) { at[j] = j <= last && s[j] == wa.max_s; });
        const int first = rh_ffs(w.ballot(at)) - 1;
        wa.end_i = w.shfl(ni, first);
        wa.cbest = first + 1;
      }
      if (!hits)  // on past the staged steps, serially
        rh_bt_walk(clen ? w.shfl(ni, clen - 1) : cidx, clen + 1, czsc, R.f,
                   R.p, claimed, P.max_drop, &wa);
      const bool accept = wa.max_s >= P.min_sc && wa.cbest > 0 && wa.cbest >= P.min_cnt;
      const bool keep = accept && c.n_u < P.k_cap;

      // claim walk: nodes 0 .. cbest - 1 (node 0 the candidate), 32 a chunk
      uint32_t ml = P.q_span, bl = P.q_span;
      int lo = cidx, next = cidx, prev_tp = 0, prev_qp = 0;
      for (int t0 = 0; t0 < wa.cbest; t0 += 32) {
        const int here = wa.cbest - t0 < 32 ? wa.cbest - t0 : 32;
        int known = clen + 1 - t0;  // nodes staged (node g is step g - 1's)
        known = known < 0 ? 0 : (known > here ? here : known);
        VI node;
        w.lanes([&](int t) {
          const int g = t0 + t;
          node[t] = g == 0 ? cidx : (t < known ? rni[g - 1] : next);
        });
        if (known < here) {  // the rest follows p
          int j = known ? R.p[w.shfl(node, known - 1)] : next;
          for (int t = known; t < here; ++t) {
            w.lanes([&](int u) {
              if (u == t) node[u] = j;
            });
            j = R.p[j];
          }
          next = j;
        } else if (t0 + 32 < wa.cbest) {
          next = R.p[w.shfl(node, here - 1)];
        }
        VI tp, qp;
        w.lanes([&](int t) {
          tp[t] = qp[t] = 0;
          if (t < here) {
            w.set_bit(claimed, node[t]);
            if (keep) {
              R.v[c.n_v + t0 + t] = node[t];
              tp[t] = R.tpos[node[t]];
              qp[t] = R.qpos[node[t]];
            }
          }
        });
        if (keep) {  // the pairs (node g - 1, node g), 1 <= g < cbest
          const VI ptp = w.shfl_up(tp), pqp = w.shfl_up(qp);
          VU dm, db;
          w.lanes([&](int t) {
            dm[t] = db[t] = 0;
            if (t < here && t0 + t >= 1)
              rh_bt_fuzzy(t ? ptp[t] : prev_tp, t ? pqp[t] : prev_qp, tp[t],
                          qp[t], P.q_span, &dm[t], &db[t]);
          });
          ml += w.sum(dm);
          bl += w.sum(db);
          prev_tp = w.shfl(tp, here - 1);
          prev_qp = w.shfl(qp, here - 1);
        }
        lo = w.shfl(node, here - 1);
        w.sync();
      }
      if (keep) {
        const int at = c.n_u;
        w.lanes([&](int t) {
          if (t == 0) {
            R.u_sc[at] = wa.max_s;
            R.u_cnt[at] = wa.cbest;
            R.u_ml[at] = (int)ml;
            R.u_bl[at] = (int)bl;
            R.u_lo[at] = lo;
            R.u_hi[at] = cidx;
          }
        });
        ++c.n_u;
        c.n_v += wa.cbest;
      } else if (accept) {
        ++c.ovf;
      }
    }
    w.sync();
    idx = n_idx;
    zsc = n_zsc;
  }
  return c;
}
