"""Device-resident index and batched seed lookup (port of
rawhash_tpu/index/device.py).

The table is flat tensors: sorted u32 keys (in int64), CSR offsets, and ONE
int64 position plane `id<<32 | pos<<1 | strand` (the reference splits it in
two u32 planes only because the TPU has no 64-bit integers).  Lookup is the
same 2-level search: a prefix table on the top hash bits, then a fixed
number of lower-bound halvings inside the bucket.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .build import RawIndex


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    keys: torch.Tensor  # int64 [K] sorted u32 hash values
    offsets: torch.Tensor  # int64 [K+1]
    pos: torch.Tensor  # int64 [N]: id<<32 | pos<<1 | strand
    prefix: torch.Tensor  # int64 [2^prefix_bits + 1]
    n_seq: int
    prefix_bits: int
    bucket_levels: int

    @staticmethod
    def from_arrays(keys, offsets, pos_id, pos_ps, prefix, n_seq: int,
                    prefix_bits: int, bucket_levels: int,
                    device) -> "DeviceIndex":
        """Tables given as the reference DeviceIndex's fields (numpy)."""
        put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        pos = (np.asarray(pos_id, np.uint64) << np.uint64(32)) | np.asarray(
            pos_ps, np.uint64
        )
        return DeviceIndex(
            keys=put(np.asarray(keys, np.uint32)),
            offsets=put(offsets),
            pos=put(pos.view(np.int64)),
            prefix=put(prefix),
            n_seq=int(n_seq),
            prefix_bits=int(prefix_bits),
            bucket_levels=int(bucket_levels),
        )

    @staticmethod
    def from_host(index: RawIndex, device) -> "DeviceIndex":
        keys = index.keys.astype(np.uint32)
        k = keys.shape[0]
        pbits = int(min(20, max(12, int(np.ceil(np.log2(max(k, 2)))) + 2)))
        bounds = np.arange((1 << pbits) + 1, dtype=np.uint64) << np.uint64(32 - pbits)
        prefix = np.searchsorted(keys.astype(np.uint64), bounds, side="left")
        max_bucket = int(np.max(np.diff(prefix))) if k else 0
        levels = 0
        while (1 << levels) < max_bucket:
            levels += 1
        pos = np.asarray(index.pos, np.uint64)
        return DeviceIndex.from_arrays(
            keys, index.offsets, pos >> np.uint64(32),
            pos & np.uint64(0xFFFFFFFF), prefix, index.n_seq, pbits, levels,
            device,
        )

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.offsets, self.pos, self.prefix))


def lookup_counts(idx: DeviceIndex, hashes: torch.Tensor, valid: torch.Tensor):
    """hashes [B,S] (u32 in int64) -> (start [B,S], count [B,S]) int64;
    count is 0 for misses and invalid seeds."""
    k = idx.keys.shape[0]
    if k == 0:
        z = torch.zeros(hashes.shape, dtype=torch.int64, device=hashes.device)
        return z, z
    b = hashes >> (32 - idx.prefix_bits)
    lo = idx.prefix[b]
    hi = idx.prefix[b + 1]
    for _ in range(idx.bucket_levels):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = idx.keys[torch.clamp(mid, 0, k - 1)] < hashes
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    i_c = torch.clamp(lo, 0, k - 1)
    found = valid & (lo < k) & (idx.keys[i_c] == hashes)
    start = idx.offsets[i_c]
    count = torch.where(found, idx.offsets[i_c + 1] - start, 0)
    return torch.where(found, start, 0), count


def expand_slots(count: torch.Tensor, a_cap: int):
    """The CSR slot assignment of per-seed hit counts [B,S] to a_cap anchor
    slots per read.  Slot n belongs to the seed whose cumulative-count
    interval holds n, as its (n - cum_before)-th occurrence.  Returns
    (seed_idx [B,A], occurrence [B,A], slot_valid [B,A], n_hits [B],
    overflow [B]); the sharded lookup (parallel/dist.py) assigns slots the
    same way from the all-reduced counts."""
    b, s = count.shape
    dev = count.device
    ccum = torch.cumsum(count, dim=1)
    n_hits = ccum[:, -1]
    cum_before = ccum - count
    slots = torch.arange(a_cap, device=dev)[None, :]
    # mark each seed's first slot, then forward-fill with a running max
    tgt = torch.where((count > 0) & (cum_before < a_cap), cum_before, a_cap)
    seed_ids = torch.arange(s, device=dev).expand(b, s)
    marker = torch.zeros((b, a_cap + 1), dtype=torch.int64, device=dev)
    marker.scatter_reduce_(1, tgt, seed_ids, reduce="amax")
    seed_c = torch.cummax(marker[:, :a_cap], dim=1).values
    n_kept = torch.clamp_max(n_hits, a_cap)
    slot_valid = slots < n_kept[:, None]
    occ = slots - torch.gather(cum_before, 1, seed_c)
    overflow = torch.clamp_min(n_hits - a_cap, 0)
    return seed_c, occ, slot_valid, n_kept, overflow


def expand_hits(idx: DeviceIndex, start: torch.Tensor, count: torch.Tensor,
                a_cap: int):
    """CSR expansion of per-seed hit runs into a_cap anchor slots per read
    (expand_slots), each slot's hit fetched from the table.

    Returns (seed_idx [B,A], hit [B,A] int64 position words, slot_valid
    [B,A], n_hits [B], overflow [B])."""
    seed_c, occ, slot_valid, n_kept, overflow = expand_slots(count, a_cap)
    fetch = torch.gather(start, 1, seed_c) + occ
    fetch = torch.where(slot_valid, fetch, 0)
    if idx.pos.shape[0] == 0:
        hit = torch.zeros_like(fetch)
    else:
        hit = idx.pos[fetch]
    return seed_c, hit, slot_valid, n_kept, overflow
