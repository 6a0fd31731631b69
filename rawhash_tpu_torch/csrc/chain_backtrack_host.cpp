// The backtrack of chain_backtrack.cuh on the host (built with g++ by
// _build.py::load_host_library), a row at a time:
//   rh_bt_serial  rh_backtrack_read, with the work each row needs
//                 (profiling/bounds.py::backtrack_work reads it);
//   rh_bt_rounds  rh_backtrack_rounds with the 32 lanes as a loop, as the
//                 kernel runs it (the tests hold it against the plain
//                 version).
// Arrays are C-contiguous int32 unless said otherwise; u holds each row's
// six chain rows (u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi) of k_cap; counts
// each row's (n_u, n_v, ovf).
#include <algorithm>
#include <vector>

#include "chain_backtrack.cuh"

extern "C" {

// zf/zi [b, n]: the full candidate order (pads first, f = INT32_MIN);
// work [b, 6] int64 (RhBtWork's fields) or null.
void rh_bt_serial(const int* zf, const int* zi, const int* f, const int* p,
                  const int* tpos, const int* qpos, int b, int n, int k_cap,
                  int min_cnt, int min_sc, int max_drop, int q_span, int* v,
                  int* u, int* counts, long long* work) {
  const RhBtParams P = {n, k_cap, min_cnt, min_sc, max_drop, q_span};
  std::vector<uint32_t> claimed((n + 31) / 32);
  for (int r = 0; r < b; ++r) {
    std::fill(claimed.begin(), claimed.end(), 0u);
    const size_t a = (size_t)r * n;
    int* ur = u + (size_t)r * 6 * k_cap;
    RhBtWork wk = {0, 0, 0, 0, 0, 0};
    const RhBtCounts c = rh_backtrack_read(
        zf + a, zi + a, f + a, p + a, tpos + a, qpos + a, claimed.data(),
        v + a, ur, ur + k_cap, ur + 2 * k_cap, ur + 3 * k_cap, ur + 4 * k_cap,
        ur + 5 * k_cap, P, &wk);
    counts[3 * r] = c.n_u;
    counts[3 * r + 1] = c.n_v;
    counts[3 * r + 2] = c.ovf;
    if (work) {
      long long* w = work + 6 * (size_t)r;
      w[0] = wk.candidates;
      w[1] = wk.skipped;
      w[2] = wk.walk_steps;
      w[3] = wk.claim_steps;
      w[4] = wk.kept;
      w[5] = wk.v_writes;
    }
  }
}

// zf/zi [b, c]: each row's n_cand candidates at its top (the kernel's
// order); the claimed bits sized for each row's n_anchors, as the kernel
// sizes them for the batch's largest.
void rh_bt_rounds(const int* zf, const int* zi, const int* n_cand,
                  const int* n_anchors, const int* f, const int* p,
                  const int* tpos, const int* qpos, int b, int n, int c,
                  int k_cap, int min_cnt, int min_sc, int max_drop, int q_span,
                  int depth, int* v, int* u, int* counts) {
  const RhBtParams P = {n, k_cap, min_cnt, min_sc, max_drop, q_span};
  const int stride = rh_bt_stride(depth);
  std::vector<int> buf(4 * 32 * stride);
  const RhBtStage st = {buf.data(), buf.data() + 32 * stride,
                        buf.data() + 64 * stride, buf.data() + 96 * stride};
  for (int r = 0; r < b; ++r) {
    int na = n_anchors[r];
    na = na < 0 ? 0 : (na > n ? n : na);
    std::vector<uint32_t> claimed((na + 31) / 32 + 1, 0u);
    const size_t a = (size_t)r * n, z = (size_t)r * c;
    int* ur = u + (size_t)r * 6 * k_cap;
    const RhBtRow R = {
        zf + z, zi + z, c - n_cand[r], c, f + a, p + a, tpos + a, qpos + a,
        v + a, ur, ur + k_cap, ur + 2 * k_cap, ur + 3 * k_cap, ur + 4 * k_cap,
        ur + 5 * k_cap};
    const RhBtCounts k =
        rh_backtrack_rounds(RhHostWarp{}, R, claimed.data(), st, depth, P);
    counts[3 * r] = k.n_u;
    counts[3 * r + 1] = k.n_v;
    counts[3 * r + 2] = k.ovf;
  }
}

}  // extern "C"
