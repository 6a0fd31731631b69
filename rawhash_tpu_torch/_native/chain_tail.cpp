// Native host chain tail: backtracking + chain compaction.
//
// The device kernel fills per-anchor (f, p) score/predecessor arrays
// (chain/device.py); this extension runs the inherently sequential tail the
// host owns: candidate walk with touched-claiming and max_drop
// (reference: mg_chain_backtrack, lchain.c:95-194) and chain compaction +
// target-position sort (reference: compact_a, lchain.c:214-281).
// Semantics match chain/host.py::chain_backtrack/compact_chains exactly;
// tests assert equality against the python oracle.
//
// Built on demand with g++ (see _native/__init__.py); plain C ABI via ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Returns number of chains (n_u). Outputs:
//   u_out[2*c], u_out[2*c+1] : score, anchor-count per chain (target-sorted)
//   bx/by  : compacted anchors, chain-major, chains sorted by first-anchor x
//   px/py  : pre-sort chain anchors (carried to the next chunk)
//   n_v_out: total anchors across chains
int32_t rh_chain_tail(
    const int32_t* f, const int32_t* p, int32_t n,
    int32_t min_cnt, int32_t min_sc, int32_t max_drop,
    const uint64_t* ax, const uint64_t* ay,
    int64_t* u_out, uint64_t* bx, uint64_t* by,
    uint64_t* px, uint64_t* py, int32_t* n_v_out)
{
    *n_v_out = 0;
    if (n <= 0) return 0;

    // candidates with acceptable score, sorted by (f, index) ascending
    std::vector<std::pair<int32_t, int32_t>> z;
    z.reserve(64);
    for (int32_t i = 0; i < n; ++i)
        if (f[i] >= min_sc) z.emplace_back(f[i], i);
    if (z.empty()) return 0;
    std::stable_sort(z.begin(), z.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });

    std::vector<int8_t> t(n, 0);
    std::vector<int32_t> v;
    v.reserve(z.size() * 4);
    std::vector<std::pair<int64_t, int64_t>> u;  // (score, cnt) discovery order

    for (int64_t k = (int64_t)z.size() - 1; k >= 0; --k) {
        int32_t zi = z[k].second;
        if (t[zi] != 0) continue;
        // find the chain start (mg_chain_bk_end, lchain.c:47-75)
        int64_t i = zi, end_i = -1, max_i = i;
        int32_t max_s = 0;
        for (;;) {
            t[i] = 2;
            end_i = i = (i >= 0 ? p[i] : -1);
            int32_t s = (i < 0) ? z[k].first : z[k].first - f[i];
            if (s > max_s) { max_s = s; max_i = i; }
            else if (max_s - s > max_drop) break;
            if (!(i >= 0 && t[i] == 0)) break;
        }
        for (int64_t j = zi; j >= 0 && j != end_i; j = p[j]) t[j] = 0;
        end_i = max_i;

        size_t n_v0 = v.size();
        int64_t walk = zi;
        while (walk != end_i) {
            v.push_back((int32_t)walk);
            t[walk] = 1;
            walk = p[walk];
        }
        int32_t sc = (walk < 0) ? z[k].first : z[k].first - f[walk];
        if (sc >= min_sc && v.size() > n_v0 &&
            (int64_t)(v.size() - n_v0) >= min_cnt) {
            u.emplace_back(sc, (int64_t)(v.size() - n_v0));
        } else {
            v.resize(n_v0);
        }
    }

    int32_t n_u = (int32_t)u.size();
    int32_t n_v = (int32_t)v.size();
    *n_v_out = n_v;
    if (n_u == 0) return 0;

    // chain anchors in increasing order (v runs are end->start)
    std::vector<int64_t> starts(n_u);
    int64_t off = 0;
    for (int32_t c = 0; c < n_u; ++c) { starts[c] = off; off += u[c].second; }
    {
        int64_t w = 0;
        for (int32_t c = 0; c < n_u; ++c) {
            int64_t cnt = u[c].second;
            for (int64_t j = 0; j < cnt; ++j) {
                int32_t idx = v[starts[c] + cnt - 1 - j];
                px[w] = ax[idx];
                py[w] = ay[idx];
                ++w;
            }
        }
    }
    // sort chains by first-anchor x (stable)
    std::vector<int32_t> order(n_u);
    for (int32_t c = 0; c < n_u; ++c) order[c] = c;
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return px[starts[a]] < px[starts[b]];
    });
    int64_t w = 0;
    for (int32_t oi = 0; oi < n_u; ++oi) {
        int32_t c = order[oi];
        u_out[2 * oi] = u[c].first;
        u_out[2 * oi + 1] = u[c].second;
        std::memcpy(bx + w, px + starts[c], u[c].second * sizeof(uint64_t));
        std::memcpy(by + w, py + starts[c], u[c].second * sizeof(uint64_t));
        w += u[c].second;
    }
    return n_u;
}

// ---------------------------------------------------------------------------
// RMQ chaining score fill (the reference's faster/looser chainer used by
// --rmq and the bw-long re-chain pass; reference: mg_lchain_rmq,
// lchain.c:606-738).  Exact mirror of chain/rmq.py::lchain_rmq_fill_np —
// the active set is kept as a (y_low, idx)-sorted vector with linear
// max-priority scans over the y-window (same inner-window refinement with
// skip/t[] pruning); tests assert bit-for-bit (f, p) equality against that
// numpy oracle.  Known boundary deviation from the reference's krmq window:
// krmq_rmq's closed-interval query (lo.i = INT32_MAX, hi.i = 0) excludes
// anchors whose y equals the query anchor's y and the far y-boundary
// (y == y_i - max_dist), while this scan's inclusive [lo_y, hi_y] admits
// both, so the winning candidate can differ on co-located anchors.  The
// divergence is documented in PARITY.md and bounded by the reference-binary
// parity tests (tests/test_ref_parity.py --rmq: 100% location agreement).

static inline float rh_mg_log2(float x) {
    // fast approximate log2 (reference: lchain.c:23-31); float32 throughout
    uint32_t z;
    std::memcpy(&z, &x, 4);
    float log_2 = (float)((int32_t)((z >> 23) & 255u) - 128);
    z = (z & ~(255u << 23)) + (127u << 23);
    float zf;
    std::memcpy(&zf, &z, 4);
    log_2 += (-0.34484843f * zf + 2.02466578f) * zf - 0.67487759f;
    return log_2;
}

static inline int64_t rh_i32lo(uint64_t v) {
    return (int64_t)(int32_t)(uint32_t)(v & 0xFFFFFFFFULL);
}

// comput_sc_simple (reference: lchain.c:557-580); float32 penalty arithmetic
// so scores match the numpy oracle bit-for-bit
static inline int64_t rh_sc_simple(
    uint64_t xi, uint64_t yi, uint64_t xj, uint64_t yj,
    float chn_pen_gap, float chn_pen_skip, bool* exact, int64_t* width)
{
    int64_t dq = rh_i32lo(yi) - rh_i32lo(yj);
    int64_t dr = (int64_t)(int32_t)(uint32_t)(xi - xj);
    int64_t dd = dr > dq ? dr - dq : dq - dr;
    int64_t dg = dr < dq ? dr : dq;
    int64_t q_span = (int64_t)((yj >> 32) & 0x3FULL);
    int64_t sc = q_span < dg ? q_span : dg;
    *exact = (dd == 0 && dg <= q_span);
    if (dd || dq > q_span) {
        float lin_pen = chn_pen_gap * (float)dd + chn_pen_skip * (float)dg;
        float log_pen = dd >= 1 ? rh_mg_log2((float)(dd + 1)) : 0.0f;
        sc -= (int64_t)(lin_pen + 0.5f * log_pen);
    }
    *width = dd;
    return sc;
}

extern "C" void rh_rmq_fill(
    const uint64_t* ax, const uint64_t* ay, int32_t n,
    int64_t max_dist, int64_t max_dist_inner, int64_t bw, int64_t max_skip,
    int64_t cap_rmq_size, double chn_pen_gap, double chn_pen_skip,
    int32_t* f, int32_t* p)
{
    if (n <= 0) return;
    if (max_dist < bw) max_dist = bw;
    if (max_dist_inner <= 0 || max_dist_inner >= max_dist) max_dist_inner = 0;
    const float pg = (float)chn_pen_gap, ps = (float)chn_pen_skip;

    // (y_low, idx)-sorted active sets; membership flags mirror the python port
    std::vector<std::pair<int64_t, int32_t>> act, inner;
    std::vector<uint8_t> in_main(n, 0), in_inner(n, 0);
    std::vector<int32_t> t(n, -1);
    int32_t st = 0, st_inner = 0, i0 = 0;

    for (int32_t i = 0; i < n; ++i) {
        int32_t max_j = -1;
        int64_t q_span = (int64_t)((ay[i] >> 32) & 0x3FULL);
        int64_t max_f = q_span;
        // delayed insert of anchors with smaller x (lchain.c:653-666)
        if (i0 < i && ax[i0] != ax[i]) {
            for (int32_t j = i0; j < i; ++j) {
                int64_t yl = rh_i32lo(ay[j]);
                auto pos = std::lower_bound(
                    act.begin(), act.end(), std::make_pair(yl, j));
                act.insert(pos, {yl, j});
                in_main[j] = 1;
                if (max_dist_inner > 0) {
                    auto pos2 = std::lower_bound(
                        inner.begin(), inner.end(), std::make_pair(yl, j));
                    inner.insert(pos2, {yl, j});
                    in_inner[j] = 1;
                }
            }
            i0 = i;
        }
        // evict out-of-range (lchain.c:668-687)
        while (st < i && ((ax[i] >> 32) != (ax[st] >> 32)
                          || ax[i] - ax[st] > (uint64_t)max_dist
                          || (int64_t)act.size() > cap_rmq_size)) {
            if (in_main[st]) {
                auto pos = std::lower_bound(
                    act.begin(), act.end(),
                    std::make_pair(rh_i32lo(ay[st]), st));
                if (pos != act.end() && pos->second == st) act.erase(pos);
                in_main[st] = 0;
            }
            ++st;
        }
        if (max_dist_inner > 0) {
            while (st_inner < i && ((ax[i] >> 32) != (ax[st_inner] >> 32)
                                    || ax[i] - ax[st_inner] > (uint64_t)max_dist_inner
                                    || (int64_t)inner.size() > cap_rmq_size)) {
                if (in_inner[st_inner]) {
                    auto pos = std::lower_bound(
                        inner.begin(), inner.end(),
                        std::make_pair(rh_i32lo(ay[st_inner]), st_inner));
                    if (pos != inner.end() && pos->second == st_inner)
                        inner.erase(pos);
                    in_inner[st_inner] = 0;
                }
                ++st_inner;
            }
        }
        // RMQ: max priority within the y-range (lchain.c:689-696); linear
        // scan in ascending (y, idx) order so ties pick the same candidate
        // as the python oracle (first max wins)
        const int64_t hi_y = rh_i32lo(ay[i]);
        const int64_t lo_y = hi_y - max_dist;
        auto lo = std::lower_bound(
            act.begin(), act.end(),
            std::make_pair(lo_y, (int32_t)INT32_MIN));
        auto hi = std::upper_bound(
            act.begin(), act.end(),
            std::make_pair(hi_y, (int32_t)INT32_MAX));
        if (lo < hi) {
            int32_t best = -1;
            double best_pri = 0.0;
            bool have = false;
            for (auto it = lo; it != hi; ++it) {
                int32_t j = it->second;
                double pri = (double)f[j] + 0.5 * chn_pen_gap *
                             (double)(rh_i32lo(ax[j]) + rh_i32lo(ay[j]));
                if (!have || pri > best_pri) {
                    have = true;
                    best_pri = pri;
                    best = j;
                }
            }
            int32_t j = best;
            bool exact;
            int64_t width;
            int64_t sc = rh_sc_simple(ax[i], ay[i], ax[j], ay[j], pg, ps,
                                      &exact, &width);
            sc += (int64_t)f[j];
            if (width <= bw && sc > max_f) { max_f = sc; max_j = j; }
            // inner refinement (lchain.c:697-724)
            if (!exact && max_dist_inner > 0 && hi_y > 0) {
                int64_t n_skip = 0;
                auto hi2 = std::upper_bound(
                    inner.begin(), inner.end(),
                    std::make_pair(hi_y - 1, (int32_t)INT32_MAX));
                for (auto it = hi2; it != inner.begin();) {
                    --it;
                    if (it->first < hi_y - max_dist_inner) break;
                    int32_t j2 = it->second;
                    bool ex2;
                    int64_t w2;
                    int64_t sc2 = rh_sc_simple(ax[i], ay[i], ax[j2], ay[j2],
                                               pg, ps, &ex2, &w2);
                    sc2 += (int64_t)f[j2];
                    if (w2 <= bw) {
                        if (sc2 > max_f) {
                            max_f = sc2;
                            max_j = j2;
                            if (n_skip > 0) --n_skip;
                        } else if (t[j2] == i) {
                            if (++n_skip > max_skip) break;
                        }
                        if (p[j2] >= 0) t[p[j2]] = i;
                    }
                }
            }
        }
        f[i] = (int32_t)max_f;
        p[i] = max_j;
    }
}

// ---------------------------------------------------------------------------
// Region pipeline: chains -> regions -> primary/secondary -> pruning.
// Semantics match chain/regions.py::gen_regs + set_parent + select_sub +
// _sync_regs exactly (reference: mm_gen_regs/mm_set_parent/mm_select_sub/
// mm_sync_regs, hit.c); tests assert equality against the python oracle.

static inline uint64_t rh_hash64(uint64_t key) {
    key = ~key + (key << 21);
    key = key ^ (key >> 24);
    key = key + (key << 3) + (key << 8);
    key = key ^ (key >> 14);
    key = key + (key << 2) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

struct RhReg {
    int64_t id, parent, score, score0, cnt, as_, rev, rid;
    int64_t rs, re, qs, qe, mlen, blen, n_sub, subsc;
    int64_t inv, is_alt, strand_retained;
    uint64_t hash;
};

static int32_t rh_region_pipeline(
    std::vector<RhReg>& regs,
    double mask_level, int32_t mask_len, int32_t hard_mask_level,
    double alt_diff_frac,
    int32_t do_select, double pri_ratio, int32_t best_n,
    int32_t check_strand, int32_t min_strand_sc,
    int64_t* out)
{
    const int32_t n_u = (int32_t)regs.size();
    // set_parent (mm_set_parent, hit.c:195-263)
    {
        std::vector<int32_t> w;
        w.reserve(n_u);
        w.push_back(0);
        regs[0].parent = 0;
        for (int32_t i = 1; i < n_u; ++i) {
            RhReg& ri = regs[i];
            int64_t si = ri.qs, ei = ri.qe;
            int64_t uncov_len = 0;
            if (!hard_mask_level) {
                std::vector<std::pair<int64_t, int64_t>> cov;
                for (int32_t wj : w) {
                    const RhReg& rp = regs[wj];
                    if (rp.qe <= si || rp.qs >= ei) continue;
                    cov.emplace_back(std::max(rp.qs, si), std::min(rp.qe, ei));
                }
                if (cov.empty()) {
                    w.push_back(i);
                    ri.parent = i;
                    ri.n_sub = 0;
                    continue;
                }
                std::sort(cov.begin(), cov.end());
                int64_t x = si;
                for (auto& se : cov) {
                    if (se.first > x) uncov_len += se.first - x;
                    x = std::max(se.second, x);
                }
                if (ei > x) uncov_len += ei - x;
            }
            bool placed = false;
            for (int32_t wj : w) {
                RhReg& rp = regs[wj];
                int64_t sj = rp.qs, ej = rp.qe;
                if (ej <= si || sj >= ei) continue;
                int64_t mn = std::min(ej - sj, ei - si);
                int64_t mx = std::max(ej - sj, ei - si);
                int64_t ol;
                if (si < sj) ol = ei < sj ? 0 : (ei < ej ? ei - sj : ej - sj);
                else ol = ej < si ? 0 : (ej < ei ? ej - si : ei - si);
                if (((double)ol / (double)mn -
                     (double)uncov_len / (double)mx) > mask_level &&
                    uncov_len <= mask_len) {
                    int64_t sci = ri.score;
                    ri.parent = rp.parent;
                    if (!rp.is_alt && ri.is_alt) {
                        if (sci >= 0) {
                            sci = (int64_t)((double)sci *
                                            (1.0 - alt_diff_frac) + 0.499);
                            if (sci <= 0) sci = 1;
                        }
                    }
                    rp.subsc = std::max(rp.subsc, sci);
                    if (ri.cnt >= rp.cnt) rp.n_sub += 1;
                    placed = true;
                    break;
                }
            }
            if (!placed) {
                w.push_back(i);
                ri.parent = i;
                ri.n_sub = 0;
            }
        }
    }

    // select_sub + sync (mm_select_sub + mm_sync_regs, hit.c:312-367)
    std::vector<int32_t> keep;
    keep.reserve(n_u);
    if (do_select && pri_ratio > 0.0) {
        int32_t n_2nd = 0;
        for (int32_t i = 0; i < n_u; ++i) {
            const RhReg& r = regs[i];
            int64_t p = r.parent;
            if (p == i || r.inv) {
                keep.push_back(i);
            } else if ((double)r.score >= (double)regs[p].score * pri_ratio &&
                       n_2nd < best_n) {
                const RhReg& rp = regs[p];
                if (!(r.qs == rp.qs && r.qe == rp.qe && r.rid == rp.rid &&
                      r.rs == rp.rs && r.re == rp.re)) {
                    keep.push_back(i);
                    ++n_2nd;
                }
            } else if (check_strand && n_2nd < best_n &&
                       r.score > min_strand_sc && r.rev != regs[p].rev) {
                regs[i].strand_retained = 1;
                keep.push_back(i);
                ++n_2nd;
            }
        }
    } else {
        for (int32_t i = 0; i < n_u; ++i) keep.push_back(i);
    }

    // sync: remap ids/parents to positions in the kept list
    std::vector<int32_t> new_of_old(n_u, -1);
    for (size_t i = 0; i < keep.size(); ++i) new_of_old[keep[i]] = (int32_t)i;
    for (size_t i = 0; i < keep.size(); ++i) {
        RhReg r = regs[keep[i]];
        int64_t old_parent = r.parent;
        r.id = (int64_t)i;
        if (old_parent == -2) r.parent = (int64_t)i;  // PARENT_TMP_PRI
        else if (old_parent >= 0 && new_of_old[old_parent] >= 0)
            r.parent = new_of_old[old_parent];
        else if ((int64_t)keep.size() != (int64_t)n_u)
            r.parent = -1;
        int64_t* o = out + 20 * i;
        o[0] = r.id; o[1] = r.parent; o[2] = r.score; o[3] = r.score0;
        o[4] = (int64_t)r.hash; o[5] = r.cnt; o[6] = r.as_; o[7] = r.rev;
        o[8] = r.rid; o[9] = r.rs; o[10] = r.re; o[11] = r.qs; o[12] = r.qe;
        o[13] = r.mlen; o[14] = r.blen; o[15] = r.n_sub; o[16] = r.subsc;
        o[17] = r.inv; o[18] = r.is_alt; o[19] = r.strand_retained;
    }
    return (int32_t)keep.size();
}

// Output row layout (int64 x 20 per region), matching the ctypes wrapper:
//  0 id, 1 parent, 2 score, 3 score0, 4 hash, 5 cnt, 6 as_, 7 rev, 8 rid,
//  9 rs, 10 re, 11 qs, 12 qe, 13 mlen, 14 blen, 15 n_sub, 16 subsc,
// 17 inv, 18 is_alt, 19 strand_retained
extern "C" int32_t rh_gen_regions(
    uint32_t read_hash, int32_t n_u,
    const int64_t* u,            // [n_u][2] (score, cnt), target-sorted
    const uint64_t* ax, const uint64_t* ay,
    double mask_level, int32_t mask_len, int32_t hard_mask_level,
    double alt_diff_frac,
    int32_t do_select,           // 0 in ALL_CHAINS mode
    double pri_ratio, int32_t best_n, int32_t check_strand,
    int32_t min_strand_sc,
    int64_t* out)
{
    if (n_u <= 0) return 0;
    const uint64_t SPAN_MASK = 0x3F;  // (1 << RI_HASH_SHIFT) - 1

    std::vector<int64_t> starts(n_u), lasts(n_u);
    {
        int64_t off = 0;
        for (int32_t c = 0; c < n_u; ++c) {
            starts[c] = off;
            off += u[2 * c + 1];
            lasts[c] = off - 1;
        }
    }

    // zx = ((score<<32)|cnt) ^ (hash64(hash64(ax0)+hash64(ay0) ^ rh) & M32)
    std::vector<uint64_t> zx(n_u);
    for (int32_t c = 0; c < n_u; ++c) {
        uint64_t h = rh_hash64(
            (rh_hash64(ax[starts[c]]) + rh_hash64(ay[starts[c]])) ^
            (uint64_t)read_hash) & 0xFFFFFFFFULL;
        zx[c] = (((uint64_t)u[2 * c] << 32) | (uint64_t)u[2 * c + 1]) ^ h;
    }

    // fuzzy match lengths per chain (mm_cal_fuzzy_len, hit.c:10-64)
    std::vector<int64_t> mlen(n_u), blen(n_u);
    for (int32_t c = 0; c < n_u; ++c) {
        int64_t span0 = (int64_t)((ay[starts[c]] >> 32) & SPAN_MASK);
        int64_t bl = span0, ml = span0;
        for (int64_t j = starts[c] + 1; j <= lasts[c]; ++j) {
            int64_t span = (int64_t)((ay[j] >> 32) & SPAN_MASK);
            int64_t tl = (int64_t)(ax[j] & 0xFFFFFFFFULL) -
                         (int64_t)(ax[j - 1] & 0xFFFFFFFFULL);
            int64_t ql = (int64_t)(ay[j] & 0xFFFFFFFFULL) -
                         (int64_t)(ay[j - 1] & 0xFFFFFFFFULL);
            int64_t mn = tl < ql ? tl : ql;
            int64_t mx = tl > ql ? tl : ql;
            bl += mx;
            ml += ((tl > span && ql > span) ? span : mn) + mn;
        }
        blen[c] = bl;
        mlen[c] = ml;
    }

    // sort descending by zx; equal keys keep REVERSED original order
    // (python: np.argsort(kind="stable")[::-1])
    std::vector<int32_t> order(n_u);
    for (int32_t c = 0; c < n_u; ++c) order[c] = c;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) { return zx[a] < zx[b]; });
    std::reverse(order.begin(), order.end());

    std::vector<RhReg> regs(n_u);
    for (int32_t i = 0; i < n_u; ++i) {
        int32_t c = order[i];
        RhReg& r = regs[i];
        uint64_t x0 = ax[starts[c]];
        r.id = i;
        r.parent = -1;
        r.score = r.score0 = (int64_t)(zx[c] >> 32);
        r.hash = zx[c] & 0xFFFFFFFFULL;
        r.cnt = u[2 * c + 1];
        r.as_ = starts[c];
        r.rev = (int64_t)(x0 >> 63);
        r.rid = (int64_t)((x0 >> 32) & 0x7FFFFFFFULL);
        r.rs = (int64_t)(x0 & 0xFFFFFFFFULL);
        r.re = (int64_t)(ax[lasts[c]] & 0xFFFFFFFFULL) + 1;
        r.qs = (int64_t)(ay[starts[c]] & 0xFFFFFFFFULL);
        r.qe = (int64_t)(ay[lasts[c]] & 0xFFFFFFFFULL) + 1;
        r.mlen = mlen[c];
        r.blen = blen[c];
        r.n_sub = 0; r.subsc = 0;
        r.inv = 0; r.is_alt = 0; r.strand_retained = 0;
    }

    return rh_region_pipeline(
        regs, mask_level, mask_len, hard_mask_level, alt_diff_frac,
        do_select, pri_ratio, best_n, check_strand, min_strand_sc, out);
}

// Regions straight from the device tail's per-chain summaries
// (chain/backtrack_device.py::compact_batch rows: score, cnt, key(u32),
// tpos0, qpos0, tposL, qposL, mlen, blen, valid) — coordinates and fuzzy
// lengths were already aggregated on-device, so this is gen_regs_from_
// summaries + set_parent + select_sub fused (hit.c:10-367) without ever
// touching per-anchor arrays.
extern "C" int32_t rh_gen_regions_summ(
    uint32_t read_hash, int32_t n_u, int32_t span,
    const int32_t* summ,         // [n_u][10]
    double mask_level, int32_t mask_len, int32_t hard_mask_level,
    double alt_diff_frac,
    int32_t do_select, double pri_ratio, int32_t best_n,
    int32_t check_strand, int32_t min_strand_sc,
    int64_t* out)
{
    if (n_u <= 0) return 0;
    std::vector<int64_t> starts(n_u);
    {
        int64_t off = 0;
        for (int32_t c = 0; c < n_u; ++c) {
            starts[c] = off;
            off += (int64_t)summ[10 * c + 1];
        }
    }
    std::vector<uint64_t> zx(n_u);
    for (int32_t c = 0; c < n_u; ++c) {
        const int32_t* sr = summ + 10 * c;
        uint64_t key = (uint64_t)(uint32_t)sr[2];
        uint64_t rev = key >> 31, rid = key & 0x7FFFFFFFULL;
        uint64_t ax0 = (rev << 63) | (rid << 32) | (uint64_t)(uint32_t)sr[3];
        uint64_t ay0 = ((uint64_t)(uint32_t)span << 32) |
                       (uint64_t)(uint32_t)sr[4];
        uint64_t h = rh_hash64(
            (rh_hash64(ax0) + rh_hash64(ay0)) ^ (uint64_t)read_hash) &
            0xFFFFFFFFULL;
        zx[c] = (((uint64_t)(uint32_t)sr[0] << 32) |
                 (uint64_t)(uint32_t)sr[1]) ^ h;
    }
    std::vector<int32_t> order(n_u);
    for (int32_t c = 0; c < n_u; ++c) order[c] = c;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) { return zx[a] < zx[b]; });
    std::reverse(order.begin(), order.end());

    std::vector<RhReg> regs(n_u);
    for (int32_t i = 0; i < n_u; ++i) {
        int32_t c = order[i];
        const int32_t* sr = summ + 10 * c;
        uint64_t key = (uint64_t)(uint32_t)sr[2];
        RhReg& r = regs[i];
        r.id = i;
        r.parent = -1;
        r.score = r.score0 = (int64_t)(zx[c] >> 32);
        r.hash = zx[c] & 0xFFFFFFFFULL;
        r.cnt = sr[1];
        r.as_ = starts[c];
        r.rev = (int64_t)(key >> 31);
        r.rid = (int64_t)(key & 0x7FFFFFFFULL);
        r.rs = sr[3];
        r.re = (int64_t)sr[5] + 1;
        r.qs = sr[4];
        r.qe = (int64_t)sr[6] + 1;
        r.mlen = sr[7];
        r.blen = sr[8];
        r.n_sub = 0; r.subsc = 0;
        r.inv = 0; r.is_alt = 0; r.strand_retained = 0;
    }
    return rh_region_pipeline(
        regs, mask_level, mask_len, hard_mask_level, alt_diff_frac,
        do_select, pri_ratio, best_n, check_strand, min_strand_sc, out);
}

}  // extern "C"
