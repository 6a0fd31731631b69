"""Multi-GPU distribution: hash-range index sharding and the collective seed
merge on torch.distributed (port of rawhash_tpu/parallel/dist.py).

  * the CSR seed table is split into `n_shards` contiguous hash ranges, each
    shard's offsets rebased to its local position slice (shard_index)
  * the ranks form a (dp, shard) grid: rank r is (r // n_shards,
    r % n_shards).  The table rides `shard`; a batch of reads is padded to
    a multiple of the world size and rank r runs its block r of rows, so
    every per-read stage (events, sketch, sort, chain fill, backtrack) is
    data parallelism over all ranks
  * the only traffic between ranks in the chunk step is the seed-hit merge
    over the rank's shard group (the ranks of its dp row): all-gather the
    group's query hashes, probe the local key range, all-reduce the counts
    (exact: each key has one owner shard), assign slots as the unsharded
    expansion does, and reduce-scatter the owned hits back to their block
    (sharded_lookup_expand)
  * everything after the lookup is the same code as the single-device step
    (map/device_step.py: chunk_step with `lookup`), so the sharded PAF is
    the single-device PAF

NCCL on cards (each rank on cuda:LOCAL_RANK), gloo on the CPU.  With
n_shards = 1 the merge runs over groups of one rank: pure data parallelism.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..index.build import RawIndex
from ..index.device import expand_slots
from ..map.device_step import (
    ChunkOut, ChunkOutTail, Lookup, chunk_step, chunk_step_tail,
    rep_len_from_filtered, unpack_hits,
)
from ..signal.events import NormCarry

U32_MAX = 0xFFFFFFFF
# how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)

# torch 2.13 renamed the two tensor collectives; the old names, which the
# torch builds of this port's cards still need, warn there
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|reduce_scatter_tensor)`",
)


@dataclasses.dataclass
class ShardedIndexArrays:
    """Host-side sharded table: dim 0 is the shard axis."""

    keys: np.ndarray  # u32 [S, Kpad] sorted per shard, U32_MAX padded
    offsets: np.ndarray  # i32 [S, Kpad+1] local CSR offsets
    pos_id: np.ndarray  # u32 [S, Npad]
    pos_ps: np.ndarray  # u32 [S, Npad]
    n_seq: int


def shard_index(index: RawIndex, n_shards: int) -> ShardedIndexArrays:
    """Split the CSR table into n_shards equal-key hash ranges."""
    k = index.keys.shape[0]
    bounds = [(s * k) // n_shards for s in range(n_shards + 1)]
    kpad = max(1, max(bounds[s + 1] - bounds[s] for s in range(n_shards)))
    npad = 1
    slices = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        o = index.offsets[lo : hi + 1]
        npad = max(npad, int(o[-1] - o[0]))
        slices.append((lo, hi, o))
    keys = np.full((n_shards, kpad), U32_MAX, dtype=np.uint32)
    offsets = np.zeros((n_shards, kpad + 1), dtype=np.int32)
    pos_id = np.zeros((n_shards, npad), dtype=np.uint32)
    pos_ps = np.zeros((n_shards, npad), dtype=np.uint32)
    for s, (lo, hi, o) in enumerate(slices):
        nk = hi - lo
        keys[s, :nk] = index.keys[lo:hi]
        local = (o - o[0]).astype(np.int32)
        offsets[s, : nk + 1] = local
        offsets[s, nk + 1 :] = local[-1]
        run = index.pos[o[0] : o[-1]]
        pos_id[s, : run.shape[0]] = (run >> np.uint64(32)).astype(np.uint32)
        pos_ps[s, : run.shape[0]] = (run & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return ShardedIndexArrays(keys, offsets, pos_id, pos_ps, index.n_seq)


def init_process_group(device: str, timeout=TIMEOUT) -> torch.device:
    """Join the process group of a sharded run and return this rank's
    device: torchrun's world where its environment is set (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), else a world of one
    on a local TCP store.  NCCL with each rank on cuda:LOCAL_RANK (set
    before the group exists) for device "cuda", gloo for "cpu"."""
    kw = backend_of(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", timeout=timeout, **kw)
    else:
        store = dist.TCPStore("localhost", 0, 1, is_master=True,
                              wait_for_workers=False)
        dist.init_process_group(store=store, rank=0, world_size=1,
                                timeout=timeout, **kw)
    return kw.get("device_id", torch.device("cpu"))


def backend_of(device: str, index: int | None = None) -> dict:
    """init_process_group's backend for a device: gloo for "cpu"; for
    "cuda", NCCL bound to cuda:index (LOCAL_RANK by default), set as the
    current device first.  The bound device makes NCCL set up each group's
    communicator when the group is made, not in its first collective."""
    if device == "cpu":
        return {"backend": "gloo"}
    if device != "cuda":
        raise ValueError(f"sharded runs take --device cuda or cpu, not {device}")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                       if index is None else index)
    torch.cuda.set_device(dev)
    return {"backend": "nccl", "device_id": dev}


def _local_lookup(keys, offsets, hashes, valid):
    """Lookup in this rank's key range: (start, count, found), int64 start
    and count (0 for misses and invalid seeds)."""
    kpad = keys.shape[0]
    i = torch.searchsorted(keys, hashes.reshape(-1), side="left").reshape(hashes.shape)
    i_c = torch.clamp(i, 0, kpad - 1)
    found = valid & (keys[i_c] == hashes) & (hashes != U32_MAX)
    start = offsets[i_c]
    count = torch.where(found, offsets[torch.clamp(i_c + 1, max=kpad)] - start, 0)
    return torch.where(found, start, 0), count, found


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t of the group, stacked along dim 0 in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if t.numel():
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def sharded_lookup_expand(keys, offsets, pos, group, hashes, qpos_seed, valid,
                          ev_offset, *, mid_occ: int, a_cap: int,
                          span: int) -> Lookup:
    """Seed lookup and CSR expansion across the shard group, with this
    rank's hash-range shard of the table (keys, offsets, pos: int64) and its
    block of batch rows (hashes, qpos_seed, valid, ev_offset).  Gives the
    same anchors in the same slots as device_step.lookup_expand on the
    whole table: the slots come from the all-reduced per-seed counts
    (expand_slots), each slot is filled by its key's one owner shard, and
    the reduce-scatter returns the merged rows to their block.  shard_hits:
    the post-filter hits this shard owns over the whole group's rows."""
    me = dist.get_rank(group)
    bl = hashes.shape[0]
    # every shard needs every row of its group: gather the queries (the
    # mask as uint8: collectives take no bools)
    hash_g = _gather(hashes, group)
    valid_g = _gather(valid.to(torch.uint8), group).bool()
    start, count_l, found = _local_lookup(keys, offsets, hash_g, valid_g)
    count_g = count_l.clone()
    dist.all_reduce(count_g, group=group)  # exact: one owner per key
    flt = count_g > mid_occ
    count_g = torch.where(flt, 0, count_g)

    seed_c, occ, slot_valid, n_hits, overflow = expand_slots(count_g, a_cap)
    mine = torch.gather(found & ~flt, 1, seed_c) & slot_valid
    fetch = torch.where(mine, torch.gather(start, 1, seed_c) + occ, 0)
    hit = torch.where(mine, pos[fetch], 0)
    # merge the shards' slots, each row to its block (one owner per slot:
    # the sum is exact)
    hit_l = torch.empty((bl, a_cap), dtype=hit.dtype, device=hit.device)
    dist.reduce_scatter_tensor(hit_l, hit, group=group)

    rows = slice(me * bl, (me + 1) * bl)
    return Lookup(
        *unpack_hits(hit_l, seed_c[rows], qpos_seed, ev_offset),
        n_hits[rows], overflow[rows],
        rep_len_from_filtered(qpos_seed, flt[rows], span),
        shard_hits=torch.where(flt, 0, count_l).sum(),
    )


class DistContext:
    """What the MappingEngine needs to run chunks on the (dp, shard) grid of
    an initialised process group: this rank's table shard on its device,
    its shard group, and the chunk steps on its block of rows.  Every rank
    creates the groups of every dp row, in the same order."""

    def __init__(self, index: RawIndex, n_shards: int, device):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.n_shards = max(1, min(n_shards, self.world))
        if self.world % self.n_shards:
            raise ValueError(f"--n-shards {n_shards}: the world size "
                             f"{self.world} is not a multiple of it")
        self.dp = self.world // self.n_shards
        self.shard = self.rank % self.n_shards
        for row in range(self.dp):
            ranks = list(range(row * self.n_shards, (row + 1) * self.n_shards))
            group = dist.new_group(ranks, timeout=TIMEOUT)
            if self.rank in ranks:
                self.group = group
        self.device = torch.device(device)
        sh = shard_index(index, self.n_shards)
        put = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)
        pos = (sh.pos_id[self.shard].astype(np.uint64) << np.uint64(32)) | sh.pos_ps[self.shard]
        self.keys = put(sh.keys[self.shard])
        self.offsets = put(sh.offsets[self.shard])
        self.pos = put(pos.view(np.int64))
        self.lookup = functools.partial(
            sharded_lookup_expand, self.keys, self.offsets, self.pos, self.group)

    def nbytes(self) -> int:
        """Bytes of this rank's table shard on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.offsets, self.pos))

    def pad_batch(self, b: int) -> int:
        """b rounded up to a multiple of the world size (padded rows have
        slen 0 and never produce anchors)."""
        return -(-b // self.world) * self.world

    def block(self, x):
        """This rank's block of rows of a whole-batch tensor or NormCarry."""
        if isinstance(x, NormCarry):
            return NormCarry(*(self.block(t) for t in x))
        bl = x.shape[0] // self.world
        return x[self.rank * bl : (self.rank + 1) * bl]

    def gather(self, x):
        """The whole batch of a tensor or NormCarry of which every rank holds
        its block; bools pass as uint8."""
        if isinstance(x, NormCarry):
            return NormCarry(*(self.gather(t) for t in x))
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8)).bool()
        return _gather(x, None)

    def step(self, *inputs, **params) -> ChunkOut:
        """device_step.chunk_step on this rank's rows (`inputs` holds its
        blocks: sig, slen, carry, ev_offset, the carried anchors, q_rank)
        with the sharded seed merge."""
        return chunk_step(None, *inputs, lookup=self.lookup, **params)

    def step_tail(self, *inputs, **params) -> ChunkOutTail:
        """device_step.chunk_step_tail on this rank's rows, as step."""
        return chunk_step_tail(None, *inputs, lookup=self.lookup, **params)
