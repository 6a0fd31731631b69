"""The port's sharded mapping (rawhash_tpu_torch/parallel/dist.py) in gloo
process worlds on the CPU, against the JAX package.

The module fixture starts two worlds, of 2 and of 4 ranks, from this file
run as a script: the workers import only the port.  They load the index
and reads that this process made with the JAX package, check the sharded
seed merge against the unsharded lookup and expansion, and map
tests/test_dist.py's multi-chunk workload (12 kb genome, 12 reads, noise
prefixes) with --n-shards in {1, 2, 4}, all-vs-all, the squeezed growth
path and the forced device tail; each rank writes what it got.  This
process computes the JAX single-device engine's records (and the JAX
sharded engine's shard_hits) and compares, PAF columns 1-12 and the tags
but the wall-clock mt:f.  Every world has a deadline: past it the workers
are killed and the tests fail.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch.config import MapFlag, MapOptions  # noqa: E402
from rawhash_tpu_torch.index.device import DeviceIndex  # noqa: E402
from rawhash_tpu_torch.index.serialize import load_index  # noqa: E402
from rawhash_tpu_torch.map.device_step import (  # noqa: E402
    chunk_step_tail, lookup_expand,
)
from rawhash_tpu_torch.map.engine import MappingEngine, fill_params  # noqa: E402
from rawhash_tpu_torch.parallel.dist import DistContext, shard_index  # noqa: E402
from rawhash_tpu_torch.signal.events import NormCarry  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DEADLINE = 600  # seconds for both worlds together
WORLDS = (2, 4)
# (name, n_shards, what the run changes): the world of 4 maps every
# scenario, the world of 2 the plain mapping at the shard counts it has
SCENARIOS = {
    2: [("map", 1), ("map", 2)],
    4: [("map", 1), ("map", 2), ("map", 4), ("ava", 4), ("growth", 2),
        ("device_tail", 1), ("device_tail", 4)],
}


# ---------------------------------------------------------------- workers


def _records(results):
    """ReadResults as JSON-able lists, PAF fields and tags but mt:f."""
    return [[r.name, [[m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       "\t".join(t for t in m.tags.split("\t")
                                 if not t.startswith("mt:f:"))]
                      for m in r.records]] for r in results]


def _reads(d):
    z = np.load(d / "reads.npz")
    return [(str(n), z[f"sig{i}"]) for i, n in enumerate(z["names"])]


def _lookup_checks(d, world):
    """The sharded seed merge against lookup_expand on the whole table, at
    each shard count the world has, with a_cap tight (overflowing rows) and
    wide, and the occurrence filter on and off; then one sharded
    chunk_step_tail against the unsharded one."""
    index = load_index(str(d / "index.rhi.npz"))
    didx = DeviceIndex.from_host(index, "cpu")
    rng = np.random.default_rng(5)
    b, s = 2 * world, 96
    keys = index.keys.astype(np.int64)
    hashes = np.where(rng.random((b, s)) < 0.8, rng.choice(keys, (b, s)),
                      rng.integers(0, 2**32 - 1, (b, s)))
    hashes[0, :4] = 0xFFFFFFFF
    inputs = (torch.from_numpy(hashes), torch.from_numpy(rng.random((b, s)) < 0.9),
              torch.from_numpy(np.sort(rng.integers(0, 900, (b, s)), axis=1)),
              torch.from_numpy(rng.integers(0, 100, b).astype(np.int32)))
    hashes_t, valid, qpos, ev_offset = inputs
    out = {}
    for n_sh in (1, 2, 4):
        if n_sh > world:
            continue
        ctx = DistContext(index, n_sh, "cpu")
        for mid_occ, a_cap in ((1, 48), (10**6, 1024)):
            want = lookup_expand(didx, hashes_t, qpos, valid, ev_offset,
                                 mid_occ=mid_occ, a_cap=a_cap, span=13)
            got = ctx.lookup(*(ctx.block(t) for t in (hashes_t, qpos, valid, ev_offset)),
                             mid_occ=mid_occ, a_cap=a_cap, span=13)
            g = {f: ctx.gather(getattr(got, f).contiguous())
                 for f in ("a_key", "a_tpos", "a_qpos", "n_hits", "overflow", "rep_len")}
            shard_hits = ctx.gather(got.shard_hits.reshape(1))
            # slots past n_hits hold no hit in either: compare the live ones
            live = torch.arange(a_cap)[None, :] < want.n_hits[:, None]
            out[f"{n_sh}_{mid_occ}_{a_cap}"] = dict(
                same=all(torch.equal(torch.where(live, g[f], 0),
                                     torch.where(live, getattr(want, f), 0))
                         for f in ("a_key", "a_tpos"))
                and all(torch.equal(g[f], getattr(want, f))
                        for f in ("a_qpos", "n_hits", "overflow", "rep_len")),
                hits=int(want.n_hits.sum()), overflow=int(want.overflow.sum()),
                filtered=int((want.rep_len > 0).sum()),
                shard_hits_total=int(shard_hits.sum()),
                all_hits=int((want.n_hits + want.overflow).sum()))
    # the device-tail step on simulated reads' first chunk
    sigs = [sig[:4000] for _, sig in _reads(d)[:b]]
    sig = torch.zeros((b, 4000))
    slen = torch.zeros(b, dtype=torch.int32)
    for i, x in enumerate(sigs):
        sig[i, : len(x)] = torch.from_numpy(x)
        slen[i] = len(x)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    step_in = (sig, slen, NormCarry.zeros(b, "cpu"), z(b), z(b, 8).long() + 0xFFFFFFFF,
               z(b, 8), z(b, 8), z(b), z(b) + 1)
    io, mo = index.opts, MapOptions()
    prm = dict(diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
               fine_min=io.fine_min, fine_max=io.fine_max,
               fine_range=io.fine_range, window_length1=mo.window_length1,
               window_length2=mo.window_length2, threshold1=mo.threshold1,
               threshold2=mo.threshold2, peak_height=mo.peak_height,
               e_cap=mo.max_events_per_chunk, a_cap=512,
               min_events=mo.min_events, mid_occ=50,
               **{k: v for k, v in fill_params(io, mo).items() if k != "q_span"},
               k_cap=64, p_out=64, min_cnt=mo.min_num_anchors,
               min_sc=mo.min_chaining_score)
    ctx = DistContext(index, world, "cpu")
    want = chunk_step_tail(didx, *step_in, **prm)
    got = ctx.step_tail(*(ctx.block(x) for x in step_in), **prm)
    fields = ("summaries", "scalars", "prev_key", "prev_tpos", "prev_qpos", "n_prev")
    out["step_tail"] = dict(
        same=all(torch.equal(ctx.gather(getattr(got, f).contiguous()), getattr(want, f))
                 for f in fields),
        chains=int(want.scalars[:, 0].sum()))
    return out


def _run_scenario(d, name, n_shards):
    """One engine run of a scenario: its records and stats."""
    reads = _reads(d)
    index = load_index(str(d / ("ava.rhi.npz" if name == "ava" else "index.rhi.npz")))
    mopt = MapOptions()
    mopt.n_shards = n_shards
    if name == "ava":
        mopt.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE
        reads = reads[:6]
    elif name == "growth":
        mopt.max_anchors_per_read = 128
        mopt.max_anchor_cap = 1 << 14
    if name == "device_tail":
        os.environ["RAWHASH_TPU_DEVICE_TAIL"] = "1"
    try:
        eng = MappingEngine(index, mopt, device="cpu")
    finally:
        os.environ.pop("RAWHASH_TPU_DEVICE_TAIL", None)
    records = _records(eng.map_batch(reads))
    stats = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in eng.stats.items()}
    return dict(records=records, stats=stats, n_shards=eng.dist.n_shards,
                device_tail=eng.device_tail)


def worker(rank: int, world: int, port: int, d: Path) -> int:
    import torch.distributed as dist

    warnings.filterwarnings("ignore", category=FutureWarning)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        out = {"lookup": _lookup_checks(d, world)}
        for name, n_shards in SCENARIOS[world]:
            out[f"{name}_{n_shards}"] = _run_scenario(d, name, n_shards)
    finally:
        dist.destroy_process_group()
    (d / f"world{world}_rank{rank}.json").write_text(json.dumps(out))
    return 0


# ---------------------------------------------------------------- tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _strip_mt(rec):
    tags = [t for t in rec.tags.split("\t") if not t.startswith("mt:f:")]
    return [rec.read_length, rec.ref_id, rec.read_start, rec.read_end,
            rec.frag_start, rec.frag_len, rec.mapq, rec.rev, rec.mapped,
            "\t".join(tags)]


def _jax_side(d):
    """Write the workload (tests/test_dist.py's) and the all-vs-all index
    with the JAX package: (index, ava_index, reads)."""
    from rawhash_tpu.config import IndexFlag as JIndexFlag
    from rawhash_tpu.config import IndexOptions as JIndexOptions
    from rawhash_tpu.index.build import (
        build_index_from_sequences, build_index_from_signals,
    )
    from rawhash_tpu.index.serialize import save_index
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=12000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, JIndexOptions())
    reads = []
    for i, (n, s, _, _) in enumerate(simulate_reads(genome, pore, n_reads=12,
                                                    read_len=1200, rng=rng)):
        if i % 2 == 0:
            noise = rng.normal(90.0, 9.0, size=6000).astype(np.float32)
            s = np.concatenate([noise, s])
        reads.append((n, s))
    iopt = JIndexOptions()
    iopt.flag |= JIndexFlag.SIG_TARGET
    ava_index = build_index_from_signals(reads[:6], pore, iopt)
    save_index(str(d / "index.rhi.npz"), index)
    save_index(str(d / "ava.rhi.npz"), ava_index)
    np.savez(d / "reads.npz", names=np.array([n for n, _ in reads]),
             **{f"sig{i}": s for i, (_, s) in enumerate(reads)})
    return index, ava_index, reads


def _jax_records(jax_side):
    """The JAX engine's records and stats per scenario: single device, and
    sharded on the 8-device CPU mesh at 1, 2 and 4 shards (shard_hits)."""
    from rawhash_tpu.config import MapFlag as JMapFlag
    from rawhash_tpu.config import MapOptions as JMapOptions
    from rawhash_tpu.map.engine import MappingEngine as JEngine

    index, ava_index, reads = jax_side
    ref = {}
    for name, n_shards in (("map", 0), ("ava", 0), ("growth", 0),
                           ("shards", 1), ("shards", 2), ("shards", 4)):
        mopt = JMapOptions()
        mopt.n_shards = n_shards
        batch, idx = list(reads), index
        if name == "ava":
            mopt.flag |= JMapFlag.ALL_CHAINS | JMapFlag.NO_ADAPTIVE
            batch, idx = batch[:6], ava_index
        elif name == "growth":
            mopt.max_anchors_per_read = 128
            mopt.max_anchor_cap = 1 << 14
        eng = JEngine(idx, mopt)
        recs = [[r.name, [_strip_mt(m) for m in r.records]] for r in eng.map_batch(batch)]
        ref[name if n_shards == 0 else f"{name}_{n_shards}"] = dict(
            records=json.loads(json.dumps(recs)), stats=dict(eng.stats))
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results per rank, and the JAX side's references."""
    d = tmp_path_factory.mktemp("dist")
    jax_side = _jax_side(d)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("RAWHASH_TPU_DEVICE_TAIL", None)
    env.pop("RAWHASH_TPU_NO_DEVICE_TAIL", None)
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(port), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    ref = _jax_records(jax_side)  # while the worlds run
    t_end = time.monotonic() + DEADLINE
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            if p.returncode != 0:
                errs.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errs.append(f"a world passed its {DEADLINE} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        pytest.fail("\n".join(errs))
    got = {w: [json.loads((d / f"world{w}_rank{r}.json").read_text())
               for r in range(w)] for w in WORLDS}
    return got, ref, jax_side


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_index_matches_jax(n_shards):
    from rawhash_tpu.config import IndexOptions as JIndexOptions
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.parallel.dist import shard_index as jax_shard_index
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    index = build_index_from_sequences([("chr1", genome)], synthetic_pore(k=6),
                                       JIndexOptions())
    want, got = jax_shard_index(index, n_shards), shard_index(index, n_shards)
    for f in ("keys", "offsets", "pos_id", "pos_ps"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.n_seq == want.n_seq
    assert int((got.keys != 0xFFFFFFFF).sum()) == index.keys.shape[0]


@pytest.mark.parametrize("world,n_shards", [(2, 1), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_sharded_lookup_expand_matches_unsharded(worlds, world, n_shards):
    got, _, _ = worlds
    rows = {k: v for k, v in got[world][0]["lookup"].items()
            if k.startswith(f"{n_shards}_")}
    assert len(rows) == 2
    for case, row in rows.items():
        assert row["same"], case
        assert row["hits"] > 0 and row["shard_hits_total"] == row["all_hits"], case
    assert rows[f"{n_shards}_1_48"]["overflow"] > 0  # a_cap 48 overflows
    assert rows[f"{n_shards}_1_48"]["filtered"] > 0  # mid_occ 1 filters seeds
    for r in range(1, world):
        assert got[world][r]["lookup"] == got[world][0]["lookup"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_chunk_step_tail_matches_unsharded(worlds, world):
    got, _, _ = worlds
    row = got[world][0]["lookup"]["step_tail"]
    assert row["same"] and row["chains"] > 0


@pytest.mark.parametrize("world,n_shards", [(2, 1), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_sharded_engine_paf_matches_jax(worlds, world, n_shards):
    """tests/test_dist.py's multi-chunk workload, the port sharded against
    the JAX single-device engine."""
    got, ref, _ = worlds
    run = got[world][0][f"map_{n_shards}"]
    assert run["n_shards"] == n_shards
    assert run["records"] == ref["map"]["records"]
    recs = [rec for _, rs in run["records"] for rec in rs]
    assert any(rec[8] for rec in recs), "nothing mapped"
    assert any("ci:i:3" in rec[9] for rec in recs)  # carried anchors in play
    assert not run["device_tail"]


def test_sharded_all_vs_all_matches_jax(worlds):
    got, ref, (_, ava_index, reads) = worlds
    run = got[4][0]["ava_4"]
    assert run["records"] == ref["ava"]["records"]
    order = {n: i for i, n in enumerate(sorted(n for n, _ in reads[:6]))}
    mapped = [(name, rec) for name, rs in run["records"] for rec in rs if rec[8]]
    assert mapped
    for name, rec in mapped:
        assert order[ava_index.seq_names[rec[1]]] > order[name]


def test_sharded_growth_matches_jax(worlds):
    """A tiny initial anchor capacity: the sharded quarantine regrows, drops
    no hit, and gives the JAX single-device engine's records."""
    got, ref, _ = worlds
    run = got[4][0]["growth_2"]
    assert run["stats"]["anchor_regrows"] > 0
    assert run["stats"]["hit_overflow"] == 0
    assert ref["growth"]["stats"]["anchor_regrows"] > 0
    assert run["records"] == ref["growth"]["records"]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_device_tail_matches_jax(worlds, n_shards):
    """The forced device tail (backtrack on each rank's rows, carried
    anchors kept there) against the JAX single-device host tail."""
    got, ref, _ = worlds
    run = got[4][0][f"device_tail_{n_shards}"]
    assert run["device_tail"] and run["stats"]["tail_chunks"] > 0
    assert run["records"] == ref["map"]["records"]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_hits_match_jax(worlds, n_shards):
    """Per shard column, the owned seed hits summed over the run equal the
    JAX sharded engine's (on its 8-device mesh: a column's total does not
    depend on dp), and every column owns some."""
    got, ref, _ = worlds
    sh = np.asarray(got[4][0][f"map_{n_shards}"]["stats"]["shard_hits"])
    want = np.asarray(ref[f"shards_{n_shards}"]["stats"]["shard_hits"])
    assert sh.shape == (4,) and want.shape == (8,)
    np.testing.assert_array_equal(sh.reshape(-1, n_shards).sum(axis=0),
                                  want.reshape(-1, n_shards).sum(axis=0))
    assert (sh.reshape(-1, n_shards).sum(axis=0) > 0).all()


def test_every_rank_reports_the_same(worlds):
    """Ranks never diverge: each rank of a world ends with rank 0's records
    and stats in every scenario."""
    got, _, _ = worlds
    for world in WORLDS:
        for r in range(1, world):
            assert got[world][r] == got[world][0], (world, r)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                    Path(sys.argv[4])))
