"""The chaining DP fill in plain PyTorch (port of rawhash_tpu/chain/device.py).

This is the fill on CPU tensors and the reference the CUDA kernel
(`chain/fill.py`, `csrc/chain_fill.cu`) is held against on the card
(reference: mg_lchain_dp, lchain.c:439-505, minus the max_skip pruning, as
in the JAX package).  Anchor i's predecessors are the W = max_iter anchors
before it.  Everything about a predecessor except its f (distances, band,
score) is known up front, so it is computed in bulk for a block of anchors
at a time; the Python loop over anchors then only adds the window's f, takes
the best, and steps the banded max_ii state.

Anchors are three int32 planes: key = rev<<31 | tid as int32 bits, tpos,
qpos.
"""

from __future__ import annotations

import torch

from ..signal.events import f32

INT32_MIN = -(2**31)
BLOCK = 64  # anchors whose window terms are computed in one go


def mg_log2(x: torch.Tensor) -> torch.Tensor:
    """Bit-twiddled fast log2 of f32 values, bit-identical to the reference
    (lchain.c:23-31)."""
    z = x.to(torch.float32).contiguous().view(torch.int32)
    log_2 = (((z >> 23) & 255) - 128).to(torch.float32)
    z = (z & ~(255 << 23)) + (127 << 23)
    zf = z.view(torch.float32)
    return log_2 + (
        (f32(-0.34484843) * zf + f32(2.02466578)) * zf - f32(0.67487759)
    )


def chain_score(dd: torch.Tensor, dg: torch.Tensor, q_span: int,
                chn_pen_gap: float, chn_pen_skip: float) -> torch.Tensor:
    """compute_score's gap-penalised score of one predecessor step
    (lchain.c:297-356): min(q_span, dg) minus the truncated penalty."""
    sc = torch.clamp_max(dg, q_span)
    lin = f32(chn_pen_gap) * dd.to(torch.float32) + f32(chn_pen_skip) * dg.to(
        torch.float32
    )
    log_pen = torch.where(dd >= 1, mg_log2((dd + 1).to(torch.float32)), 0.0)
    pen = (lin + 0.5 * log_pen).to(torch.int32)
    return torch.where((dd != 0) | (dg > q_span), sc - pen, sc)


def _window_scores(key_i, tpos_i, qpos_i, w_key, w_tpos, w_qpos, j_valid,
                   q_span, max_dist_t, max_dist_q, bw, chn_pen_gap,
                   chn_pen_skip):
    """compute_score of anchors [...] against their predecessor windows
    [..., W].  Returns (score, ok, in_band): ok marks allowed predecessors,
    whose total is score + f[j]; in_band ones count toward the band."""
    dq = qpos_i[..., None] - w_qpos
    dr = tpos_i[..., None] - w_tpos
    in_band = j_valid & (w_key == key_i[..., None]) & (dr <= max_dist_t) & (dr >= 0)
    dd = torch.abs(dr - dq)
    ok = (
        in_band & (dq > 0) & (dq <= max_dist_q) & (dr != 0) & (dd <= bw)
        & (dr <= max_dist_q)
    )
    sc = chain_score(dd, torch.minimum(dr, dq), q_span, chn_pen_gap, chn_pen_skip)
    return sc, ok, in_band


def _max_last(x: torch.Tensor, cols: torch.Tensor, j0: int):
    """Row maximum of x [B, W] and the largest column (from cols, int64 [W])
    holding it, plus j0, both int64 [B, 1]: (value, column) packed in one
    int64 so that a single max breaks ties to the largest column."""
    m = ((x.to(torch.int64) << 32) | cols).max(dim=1, keepdim=True).values
    return m >> 32, (m & 0xFFFFFFFF) + j0


def chain_fill_batch(
    key: torch.Tensor,  # i32 [B, N] key bits
    tpos: torch.Tensor,  # i32 [B, N]
    qpos: torch.Tensor,  # i32 [B, N]
    n_anchors: torch.Tensor,  # i32 [B]
    *,
    q_span: int,
    max_dist_t: int,
    max_dist_q: int,
    bw: int,
    max_iter: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
):
    """Fill f [B,N] i32 (best chain score ending at each anchor) and p [B,N]
    i32 (best predecessor, -1 if none); slots past n_anchors get 0 and -1.
    Ties between predecessors go to the largest index."""
    b, n = key.shape
    dev = key.device
    w = max_iter
    max_dist_t = max(max_dist_t, bw)
    max_dist_q = max(max_dist_q, bw)
    score = dict(q_span=q_span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
                 bw=bw, chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip)
    # w leading pad slots, so the window of anchor i (anchors i-w .. i-1) is
    # columns i .. i+w-1 of a padded plane; f of anchor j sits at column w+j
    pad = lambda x: torch.nn.functional.pad(x, (w, 0))
    k_pad, t_pad, q_pad = pad(key), pad(tpos), pad(qpos)
    f_pad = torch.full((b, w + n), INT32_MIN, dtype=torch.int32, device=dev)
    p_out = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    # the banded out-of-window predecessor max_ii, -1 if none (reference:
    # lchain.c:473-503); its fields are read from the planes by index
    mii = torch.full((b, 1), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(w, device=dev)
    n_live = min(int(n_anchors.max()), n) if b else 0

    # per step, every per-read value is a [B, 1] column
    for i0 in range(0, n_live, BLOCK):
        i1 = min(i0 + BLOCK, n_live)
        win = lambda x: x[:, i0 : i1 + w - 1].unfold(1, w, 1)  # [B, T, W]
        anchor_ids = torch.arange(i0, i1, device=dev)
        j_valid = (anchor_ids[:, None] - w + slots >= 0).expand(b, -1, -1)
        sc, ok, in_band = _window_scores(
            key[:, i0:i1], tpos[:, i0:i1], qpos[:, i0:i1],
            win(k_pad), win(t_pad), win(q_pad), j_valid, **score,
        )
        cols = [x[:, i0:i1].split(1, dim=1) for x in (key, tpos, qpos)]
        n_inband = in_band.sum(dim=2).split(1, dim=1)
        sc, ok, in_band = sc.unbind(1), ok.unbind(1), in_band.unbind(1)
        p_blk = []

        for t in range(i1 - i0):
            i = i0 + t
            k_i, t_i, q_i = cols[0][t], cols[1][t], cols[2][t]
            f_win = f_pad[:, i : i + w]
            best, best_j = _max_last(
                torch.where(ok[t], sc[t] + f_win, INT32_MIN), slots, i - w
            )
            found = best > q_span
            max_f = torch.where(found, best, q_span)
            max_j = torch.where(found, best_j, -1)

            # refresh max_ii when it left the band: the in-band predecessor
            # with the best f (largest j on ties), or none
            re_f, re_j = _max_last(torch.where(in_band[t], f_win, INT32_MIN),
                                   slots, i - w)
            at = mii.clamp_min(0)
            m_key, m_tpos = key.gather(1, at), tpos.gather(1, at)
            stale = (
                (mii < 0) | (m_key != k_i) | ((t_i - m_tpos) > max_dist_t)
                | (t_i < m_tpos)
            )
            mii = torch.where(stale, torch.where(re_f > INT32_MIN, re_j, -1), mii)

            # score against max_ii when it sits before the examined window
            at = mii.clamp_min(0)
            m_key, m_tpos, m_qpos = (x.gather(1, at) for x in (key, tpos, qpos))
            m_f = f_pad.gather(1, mii + w)
            dq = q_i - m_qpos
            dr = t_i - m_tpos
            dd = torch.abs(dr - dq)
            m_ok = (
                (mii >= 0) & (mii < i - n_inband[t]) & (m_key == k_i)
                & (dq > 0) & (dq <= max_dist_q) & (dr > 0) & (dr <= max_dist_t)
                & (dd <= bw) & (dr <= max_dist_q)
            )
            cand = torch.where(
                m_ok,
                chain_score(dd, torch.minimum(dr, dq), q_span, chn_pen_gap,
                            chn_pen_skip) + m_f,
                INT32_MIN,
            )
            better = m_ok & (cand > max_f)
            f_i = torch.where(better, cand, max_f)
            p_blk.append(torch.where(better, mii, max_j))

            # advance max_ii to i when i dominates (reference: lchain.c:503)
            adv = (mii < 0) | (
                (m_key == k_i) & (t_i >= m_tpos) & ((t_i - m_tpos) <= max_dist_t)
                & (m_f < f_i)
            )
            mii = torch.where(adv, i, mii)
            f_pad[:, w + i : w + i + 1] = f_i
        p_out[:, i0:i1] = torch.cat(p_blk, dim=1)

    live = torch.arange(n, device=dev)[None, :] < n_anchors[:, None]
    f = torch.where(live, f_pad[:, w:], 0)
    p = torch.where(live, p_out, -1).to(torch.int32)
    return f, p
