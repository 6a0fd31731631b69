"""Chaining (RawHash2's lchain.c as the port runs it): the DP fill in NumPy
over a block of rows (mg_lchain_dp without the max_skip pruning,
predecessors the max_iter anchors before each), then per read the
backtrack (mg_chain_backtrack) and the compaction (compact_a) in NumPy."""

from __future__ import annotations

import numpy as np

INT32_MIN = -(2**31)
BLOCK = 64


F32 = np.float32


def mg_log2(x):
    """The bit-twiddled fast log2 of f32 values (lchain.c:23-31)."""
    z = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    log_2 = (((z >> 23) & 255) - 128).astype(np.float32)
    z = (z & np.int32(~(255 << 23))) + np.int32(127 << 23)
    zf = z.view(np.float32)
    return log_2 + ((F32(-0.34484843) * zf + F32(2.02466578)) * zf - F32(0.67487759))


def chain_score(dd, dg, q_span, chn_pen_gap, chn_pen_skip):
    """min(q_span, dg) minus the truncated gap penalty (lchain.c:297-356)."""
    sc = np.minimum(dg, q_span).astype(np.int32)
    lin = F32(chn_pen_gap) * dd.astype(np.float32) + F32(chn_pen_skip) * dg.astype(np.float32)
    log_pen = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)), F32(0.0))
    pen = (lin + F32(0.5) * log_pen).astype(np.int32)
    return np.where((dd != 0) | (dg > q_span), sc - pen, sc).astype(np.int32)


def _window_scores(key_i, tpos_i, qpos_i, w_key, w_tpos, w_qpos, j_valid, q_span,
                   max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip):
    dq = qpos_i[..., None] - w_qpos
    dr = tpos_i[..., None] - w_tpos
    in_band = j_valid & (w_key == key_i[..., None]) & (dr <= max_dist_t) & (dr >= 0)
    dd = np.abs(dr - dq)
    ok = (in_band & (dq > 0) & (dq <= max_dist_q) & (dr != 0) & (dd <= bw)
          & (dr <= max_dist_q))
    sc = chain_score(dd, np.minimum(dr, dq), q_span, chn_pen_gap, chn_pen_skip)
    return sc, ok, in_band


def _max_last(x, cols, j0: int):
    """Row max of x [B, W] and the largest column holding it (+ j0)."""
    m = ((x.astype(np.int64) << 32) | cols).max(axis=1, keepdims=True)
    return m >> 32, (m & 0xFFFFFFFF) + j0


def chain_fill(key, tpos, qpos, n_anchors, *, q_span, max_dist_t, max_dist_q, bw,
               max_iter, chn_pen_gap, chn_pen_skip):
    """f and p (i32 [B, N]) of rows (int32 NumPy) sorted by (key, tpos);
    slots past n_anchors get 0 and -1; ties between predecessors go to the
    largest index.  The port's plain fill, stepped in NumPy."""
    from numpy.lib.stride_tricks import sliding_window_view

    b, n = key.shape
    w = max_iter
    max_dist_t = max(max_dist_t, bw)
    max_dist_q = max(max_dist_q, bw)
    score = dict(q_span=q_span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
                 bw=bw, chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip)
    pad = lambda x: np.pad(x, ((0, 0), (w, 0)))
    k_pad, t_pad, q_pad = pad(key), pad(tpos), pad(qpos)
    f_pad = np.full((b, w + n), INT32_MIN, dtype=np.int32)
    p_out = np.full((b, n), -1, dtype=np.int64)
    mii = np.full((b, 1), -1, dtype=np.int64)
    slots = np.arange(w, dtype=np.int64)
    n_live = min(int(n_anchors.max()), n) if b else 0
    take = lambda x, at: np.take_along_axis(x, at, 1)
    for i0 in range(0, n_live, BLOCK):
        i1 = min(i0 + BLOCK, n_live)
        win = lambda x: sliding_window_view(x[:, i0 : i1 + w - 1], w, axis=1)
        j_valid = (np.arange(i0, i1)[:, None] - w + slots >= 0)[None]
        sc, ok, in_band = _window_scores(key[:, i0:i1], tpos[:, i0:i1], qpos[:, i0:i1],
                                         win(k_pad), win(t_pad), win(q_pad), j_valid,
                                         **score)
        n_inband = in_band.sum(axis=2)
        for t in range(i1 - i0):
            i = i0 + t
            k_i, t_i, q_i = key[:, i : i + 1], tpos[:, i : i + 1], qpos[:, i : i + 1]
            f_win = f_pad[:, i : i + w]
            best, best_j = _max_last(np.where(ok[:, t], sc[:, t] + f_win, INT32_MIN),
                                     slots, i - w)
            found = best > q_span
            max_f = np.where(found, best, q_span)
            max_j = np.where(found, best_j, -1)
            re_f, re_j = _max_last(np.where(in_band[:, t], f_win, INT32_MIN), slots, i - w)
            at = np.maximum(mii, 0)
            m_key, m_tpos = take(key, at), take(tpos, at)
            stale = ((mii < 0) | (m_key != k_i) | ((t_i - m_tpos) > max_dist_t)
                     | (t_i < m_tpos))
            mii = np.where(stale, np.where(re_f > INT32_MIN, re_j, -1), mii)
            at = np.maximum(mii, 0)
            m_key, m_tpos, m_qpos = take(key, at), take(tpos, at), take(qpos, at)
            m_f = take(f_pad, mii + w)
            dq = q_i - m_qpos
            dr = t_i - m_tpos
            dd = np.abs(dr - dq)
            m_ok = ((mii >= 0) & (mii < i - n_inband[:, t : t + 1]) & (m_key == k_i)
                    & (dq > 0) & (dq <= max_dist_q) & (dr > 0) & (dr <= max_dist_t)
                    & (dd <= bw) & (dr <= max_dist_q))
            if m_ok.any():
                cand = np.where(m_ok, chain_score(dd, np.minimum(dr, dq), q_span,
                                                  chn_pen_gap, chn_pen_skip) + m_f,
                                INT32_MIN)
                better = m_ok & (cand > max_f)
                f_i = np.where(better, cand, max_f)
                p_out[:, i : i + 1] = np.where(better, mii, max_j)
            else:
                f_i = max_f
                p_out[:, i : i + 1] = max_j
            adv = (mii < 0) | ((m_key == k_i) & (t_i >= m_tpos)
                               & ((t_i - m_tpos) <= max_dist_t) & (m_f < f_i))
            mii = np.where(adv, i, mii)
            f_pad[:, w + i : w + i + 1] = f_i
    live = np.arange(n)[None, :] < n_anchors[:, None]
    f = np.where(live, f_pad[:, w:], 0).astype(np.int32)
    p = np.where(live, p_out, -1).astype(np.int32)
    return f, p


def chain_backtrack(f, p, min_cnt: int, min_sc: int, max_drop: int):
    """All chains (mg_chain_backtrack, lchain.c:95-194): u = (score, count)
    per chain in discovery order, v = anchor indices chain-major, each
    chain end to start."""
    n = f.shape[0]
    zi = np.nonzero(f >= min_sc)[0]
    if zi.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=np.int64)
    order = np.argsort(f[zi], kind="stable")
    z_score = f[zi][order].astype(np.int64)
    z_idx = zi[order].astype(np.int64)
    t = np.zeros(n, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    n_v = 0
    u = []
    for k in range(z_idx.shape[0] - 1, -1, -1):
        if t[z_idx[k]] != 0:
            continue
        n_v0 = n_v
        end_i = _bk_end(max_drop, z_score, z_idx, f, p, t, k)
        i = z_idx[k]
        while i != end_i:
            v[n_v] = i
            n_v += 1
            t[i] = 1
            i = p[i]
        sc = int(z_score[k]) if i < 0 else int(z_score[k]) - int(f[i])
        if sc >= min_sc and n_v > n_v0 and n_v - n_v0 >= min_cnt:
            u.append((sc, n_v - n_v0))
        else:
            n_v = n_v0
    return np.asarray(u, dtype=np.int64).reshape(-1, 2), v[:n_v]


def _bk_end(max_drop, z_score, z_idx, f, p, t, k):
    """mg_chain_bk_end (lchain.c:47-75)."""
    i = z_idx[k]
    if i < 0 or t[i] != 0:
        return i
    max_i = i
    max_s = 0
    end_i = -1
    while True:
        t[i] = 2
        end_i = i = p[i]
        s = int(z_score[k]) if i < 0 else int(z_score[k]) - int(f[i])
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if not (i >= 0 and t[i] == 0):
            break
    i = z_idx[k]
    while i >= 0 and i != end_i:
        nxt = p[i]
        t[i] = 0
        i = nxt
    return max_i


def compact_chains(u, v, ax, ay):
    """compact_a (lchain.c:214-281): (u sorted by first-anchor x, bx, by
    chain-major in that order, prev_x, prev_y in discovery order)."""
    n_u = u.shape[0]
    if n_u == 0:
        e = np.zeros(0, dtype=np.uint64)
        return u, e, e.copy(), e.copy(), e.copy()
    cnts = u[:, 1]
    ends = np.cumsum(cnts)
    starts = ends - cnts
    idx = np.concatenate([v[s : s + c][::-1] for s, c in zip(starts, cnts)]).astype(np.int64)
    bx, by = ax[idx], ay[idx]
    prev_x, prev_y = bx.copy(), by.copy()
    order = np.argsort(bx[starts], kind="stable")
    out_idx = np.concatenate([np.arange(starts[c], ends[c]) for c in order])
    return u[order], bx[out_idx], by[out_idx], prev_x, prev_y
