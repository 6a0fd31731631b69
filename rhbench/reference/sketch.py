"""Seeds from events (RawHash2's rsketch.c): the event-difference filter,
q-bit dynamic quantisation, the e-event rolling pack and the 32-bit hash.
`sketch_batch` sketches a chunk's reads in plain PyTorch; `sketch_events_np`
sketches a genome's expected signal in NumPy for the index."""

from __future__ import annotations

import numpy as np
import torch

from .events import dense_compact, f32

U32 = 0xFFFFFFFF
RI_ID_SHIFT = 32
RI_POS_SHIFT = 1


def dynamic_quantize_np(signal, fine_min, fine_max, fine_range, n_buckets):
    """Dynamic quantisation (rsketch.c:18-53), int32 codes (unmasked)."""
    sig = np.asarray(signal, dtype=np.float32)
    min_val, max_val = np.float32(-3.0), np.float32(3.0)
    rng = max_val - min_val
    coarse1 = np.float32((1.0 - fine_range) / 2.0)
    coarse2 = np.float32(fine_range) + coarse1
    normalized = (sig - min_val) / rng
    a = (np.float32(fine_min) - min_val) / rng
    b = (np.float32(fine_max) - min_val) / rng
    fine = np.float32(fine_range) * ((normalized - a) / (b - a))
    coarse = np.where(normalized < 0.5, np.float32(fine_range) + coarse1 * normalized,
                      coarse2 + coarse1 * normalized)
    quantized = np.where((sig >= fine_min) & (sig <= fine_max), fine, coarse)
    scaled = quantized * np.float32(n_buckets - 1)
    return np.trunc(scaled).astype(np.int64).astype(np.int32)


def hash32_np(key):
    """The 32-bit invertible mixing hash (rsketch.c:7-16), uint32."""
    key = np.asarray(key, dtype=np.uint32)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint32(21)))
        key = key ^ (key >> np.uint32(24))
        key = (key + (key << np.uint32(3))) + (key << np.uint32(8))
        key = key ^ (key >> np.uint32(14))
        key = (key + (key << np.uint32(2))) + (key << np.uint32(4))
        key = key ^ (key >> np.uint32(28))
        key = key + (key << np.uint32(31))
    return key


def diff_compact_indices(values, diff: float):
    """Indices kept by the event-difference filter: kept[0] = 0, then the
    next event differing from the last kept one by >= diff."""
    v = np.asarray(values, dtype=np.float32)
    n = v.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if diff <= 0.0:
        return np.arange(n, dtype=np.int64)
    nxt = np.full(n, n, dtype=np.int64)
    unresolved = np.ones(n, dtype=bool)
    d = 1
    max_rounds = 256
    while d <= max_rounds and d < n and unresolved[: n - d].any():
        hit = np.abs(v[d:] - v[: n - d]) >= diff
        newly = unresolved[: n - d] & hit
        nxt[: n - d][newly] = np.nonzero(newly)[0] + d
        unresolved[: n - d] &= ~hit
        d += 1
    if d >= max_rounds:
        for i in np.nonzero(unresolved[: max(0, n - max_rounds)])[0]:
            rest = np.abs(v[i + max_rounds :] - v[i]) >= diff
            j = np.argmax(rest)
            if rest[j]:
                nxt[i] = i + max_rounds + j
    jmp = np.concatenate([nxt, np.array([n], dtype=np.int64)])
    path = np.array([0], dtype=np.int64)
    while path[-1] != n and path.shape[0] <= n:
        path = np.concatenate([path, jmp[path]])
        jmp = jmp[jmp]
    return path[path < n]


def pack_and_hash(codes, e: int, q: int):
    """Rolling e-code pack (low 32 bits) hashed, one per window end."""
    codes = np.asarray(codes, dtype=np.uint64)
    m = codes.shape[0]
    if m < e:
        return np.zeros(0, dtype=np.uint32)
    packed = np.zeros(m - e + 1, dtype=np.uint64)
    for j in range(e):
        packed |= codes[j : m - e + 1 + j] << np.uint64(q * (e - 1 - j))
    if q * e < 64:
        packed &= np.uint64((1 << (q * e)) - 1)
    return hash32_np(packed.astype(np.uint32))


def minimizer_mask(hashes, w: int):
    """Seeds that are the minimum (ties included) of a w-window of seeds."""
    m = hashes.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    if m < w:
        mask = np.zeros(m, dtype=bool)
        mask[np.nonzero(hashes == hashes.min())[0][-1]] = True
        return mask
    wmin = hashes[: m - w + 1].copy()
    for s in range(1, w):
        np.minimum(wmin, hashes[s : m - w + 1 + s], out=wmin)
    mask = np.zeros(m, dtype=bool)
    for s in range(w):
        mask[s : s + m - w + 1] |= hashes[s : s + m - w + 1] == wmin
    return mask


def sketch_events_np(values, sid: int, strand: int, o: dict):
    """(hashes uint32, y = sid<<32 | pos<<1 | strand uint64) of an event
    stream, pos the first event of each seed (ri_sketch)."""
    values = np.asarray(values, dtype=np.float32)
    kept = diff_compact_indices(values, o["diff"])
    codes = dynamic_quantize_np(values[kept], o["fine_min"], o["fine_max"],
                                o["fine_range"], 1 << o["q"]) & np.int32((1 << o["q"]) - 1)
    hashes = pack_and_hash(codes, o["e"], o["q"])
    if hashes.shape[0] == 0:
        return hashes, np.zeros(0, dtype=np.uint64)
    pos = kept[: hashes.shape[0]]
    if o["w"]:
        mask = minimizer_mask(hashes, o["w"])
        hashes, pos = hashes[mask], pos[mask]
    y = ((np.uint64(sid) << np.uint64(RI_ID_SHIFT))
         | (pos.astype(np.uint64) << np.uint64(RI_POS_SHIFT)) | np.uint64(strand))
    return hashes, y


def _diff_filter(events, n_ev, diff: float):
    """Keep mask [B, E]: events differing from the last kept one by >= diff
    (the first live event always kept)."""
    b, e = events.shape
    thr = f32(diff)
    keep = torch.zeros((b, e), dtype=torch.bool)
    last = torch.zeros(b, dtype=torch.float32)
    n_live = int(n_ev.max()) if b else 0
    for t in range(min(n_live, e)):
        v = events[:, t]
        k = t < n_ev
        if t > 0:
            k = k & (torch.abs(v - last) >= thr)
        last = torch.where(k, v, last)
        keep[:, t] = k
    return keep


def dynamic_quantize(signal, fine_min, fine_max, fine_range, n_buckets):
    """dynamic_quantize_np on a tensor, every constant rounded to f32."""
    f = np.float32
    sig = signal.to(torch.float32)
    min_val, max_val = f(-3.0), f(3.0)
    rng = max_val - min_val
    coarse1 = f((1.0 - fine_range) / 2.0)
    coarse2 = f(fine_range) + coarse1
    a = (f(fine_min) - min_val) / rng
    b = (f(fine_max) - min_val) / rng
    normalized = (sig - float(min_val)) / float(rng)
    fine = float(f(fine_range)) * ((normalized - float(a)) / float(b - a))
    coarse = torch.where(normalized < 0.5, float(f(fine_range)) + float(coarse1) * normalized,
                         float(coarse2) + float(coarse1) * normalized)
    in_fine = (sig >= float(f(fine_min))) & (sig <= float(f(fine_max)))
    quantized = torch.where(in_fine, fine, coarse)
    return torch.trunc(quantized * float(f(n_buckets - 1))).to(torch.int32)


def hash32(key):
    """hash32_np on u32 values carried in int64."""
    key = key.to(torch.int64) & U32
    key = ((~key & U32) + ((key << 21) & U32)) & U32
    key = key ^ (key >> 24)
    key = (key + ((key << 3) & U32) + ((key << 8) & U32)) & U32
    key = key ^ (key >> 14)
    key = (key + ((key << 2) & U32) + ((key << 4) & U32)) & U32
    key = key ^ (key >> 28)
    return (key + ((key << 31) & U32)) & U32


def sketch_batch(events, n_ev, o: dict):
    """(hashes int64 [B,E] holding u32, qpos int64 [B,E]: the chunk position
    of each seed's first kept event, valid bool [B,E])."""
    b, cap = events.shape
    e, q, w = o["e"], o["q"], o["w"]
    keep = _diff_filter(events, n_ev, o["diff"])
    vals, n_kept = dense_compact(events, keep)
    kept_pos, _ = dense_compact(torch.arange(cap).expand(b, cap), keep)
    codes = dynamic_quantize(vals, o["fine_min"], o["fine_max"], o["fine_range"],
                             1 << q).to(torch.int64) & ((1 << q) - 1)
    packed = torch.zeros((b, cap), dtype=torch.int64)
    for j in range(e):
        rolled = torch.nn.functional.pad(codes, (j, 0))[:, :cap]
        packed = packed | (rolled << (q * j))
    packed = packed & (U32 if q * e >= 32 else (1 << (q * e)) - 1)
    hashes = hash32(packed)
    t_idx = torch.arange(cap)[None, :]
    valid = (t_idx >= e - 1) & (t_idx < n_kept[:, None])
    qpos = torch.gather(kept_pos, 1, torch.clamp(t_idx - (e - 1), 0, cap - 1).expand(b, cap))
    if w:
        hm = torch.where(valid, hashes, U32)
        wmin = hm
        for d in range(1, w):
            wmin = torch.minimum(wmin, torch.nn.functional.pad(hm, (0, d), value=U32)[:, d:])
        winv = (t_idx >= e - 1) & (t_idx + (w - 1) < n_kept[:, None])
        emit = torch.zeros_like(valid)
        for d in range(w):
            shifted = torch.nn.functional.pad(wmin, (d, 0), value=U32)[:, :cap]
            shifted_ok = torch.nn.functional.pad(winv, (d, 0))[:, :cap]
            emit = emit | ((hm == shifted) & shifted_ok)
        valid = valid & emit
    return hashes, qpos, valid
