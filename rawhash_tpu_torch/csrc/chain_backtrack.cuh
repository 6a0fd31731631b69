// The greedy all-chains backtrack of one read (reference: mg_chain_backtrack,
// lchain.c:95-194), as one function that compiles for the card and for the
// host: csrc/chain_backtrack.cu runs it in lane 0 of a warp per read, and
// the tests build it with g++ and hold it against the plain PyTorch version
// (rawhash_tpu_torch/chain/backtrack_device.py::backtrack_plain).
//
// It computes what the reference package's lockstep backtrack
// (rawhash_tpu/chain/backtrack_device.py::backtrack_batch) computes, plus
// the chain statistics of its chain-stat kernel
// (rawhash_tpu/chain/backtrack_pallas_big.py), bit for bit:
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
//     hit.c:10-40).  An accepted chain that does not fit counts in ovf.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RH_BT_FN __host__ __device__ inline
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

// One read.  zf/zi: the candidate order ((f, idx) ascending, pads first with
// f = INT32_MIN); f, p, tpos, qpos: the read's rows; claimed: n bits, zero
// on entry.  v [n] and the seven chain rows [k_cap] are written only below
// the returned n_v / n_u.
RH_BT_FN RhBtCounts rh_backtrack_read(
    const int* zf, const int* zi, const int* f, const int* p, const int* tpos,
    const int* qpos, uint32_t* claimed, int* v, int* u_sc, int* u_cnt,
    int* u_ml, int* u_bl, int* u_lo, int* u_hi, RhBtParams P) {
  RhBtCounts c = {0, 0, 0};
  for (int k = P.n - 1; k >= 0; --k) {
    const int zsc = zf[k];
    if (zsc < P.min_sc) break;
    const int idx = zi[k];
    if ((claimed[idx >> 5] >> (idx & 31)) & 1u) continue;

    // walk A: the score peak along the predecessor chain
    int i = idx, end_i = idx, max_s = 0, cbest = 0;
    for (int step = 1;; ++step) {
      const int ni = p[i];
      const int s = ni < 0 ? zsc : zsc - f[ni];
      const bool better = s > max_s;
      const bool brk = !better && max_s - s > P.max_drop;
      if (better) {
        max_s = s;
        end_i = ni;
        cbest = step;
      }
      if (brk || ni < 0 || ((claimed[ni >> 5] >> (ni & 31)) & 1u)) break;
      i = ni;
    }
    const bool accept = max_s >= P.min_sc && cbest > 0 && cbest >= P.min_cnt;
    const bool keep = accept && c.n_u < P.k_cap;

    // claim walk: candidate -> end_i (exclusive), claim-ordered
    int ml = P.q_span, bl = P.q_span, lo = idx, m = 0;
    int tp = keep ? tpos[idx] : 0, qp = keep ? qpos[idx] : 0;
    for (int j = idx; j != end_i; ++m) {
      claimed[j >> 5] |= 1u << (j & 31);
      const int j2 = p[j];
      if (keep) {
        v[c.n_v + m] = j;
        if (j2 != end_i) {
          const int tp2 = tpos[j2], qp2 = qpos[j2];
          const int tl = tp - tp2, ql = qp - qp2;
          const int mn = tl < ql ? tl : ql, mx = tl < ql ? ql : tl;
          ml += (tl > P.q_span && ql > P.q_span ? P.q_span : mn) + mn;
          bl += mx;
          tp = tp2;
          qp = qp2;
        }
      }
      lo = j;
      j = j2;
    }
    if (keep) {
      u_sc[c.n_u] = max_s;
      u_cnt[c.n_u] = cbest;
      u_ml[c.n_u] = ml;
      u_bl[c.n_u] = bl;
      u_lo[c.n_u] = lo;
      u_hi[c.n_u] = idx;
      ++c.n_u;
      c.n_v += cbest;
    } else if (accept) {
      ++c.ovf;
    }
  }
  return c;
}
