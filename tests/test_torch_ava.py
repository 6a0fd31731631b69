"""All-vs-all overlapping (Rawsamble) in the port against the JAX package:
the rank filter of merge_sort_fill bit for bit, the engines' records field
for field on both tails, tests/test_ava.py's properties, and the CLI's PAF
columns 1-12 (`-x ava --sig-target` index, then mapping)."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.index.build import build_index_from_signals as jax_build  # noqa: E402
from rawhash_tpu.map import device_step as jstep  # noqa: E402
from rawhash_tpu.map.engine import MappingEngine as JaxEngine  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.index.build import build_index_from_signals  # noqa: E402
from rawhash_tpu_torch.io.sigfile import write_sig_npz  # noqa: E402
from rawhash_tpu_torch.map import device_step as tstep  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine, fill_params  # noqa: E402
from rawhash_tpu_torch.synthetic import ava_fixture_reads, options  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_sort_fill_rank_filter_matches_jax(seed):
    """Random hits over 6 targets, carried anchors and name ranks: the
    filtered, merged, sorted and filled planes equal JAX's bit for bit."""
    rng = np.random.default_rng(seed)
    b, a_cap, p_cap, n_seq = 5, 96, 16, 6
    io, mo = options("ava")
    prm = fill_params(io, mo)
    tid = rng.integers(0, n_seq, (b, a_cap)).astype(np.uint32)
    rev = rng.integers(0, 2, (b, a_cap)).astype(np.uint32)
    a_key = (rev << 31) | tid
    a_tpos = rng.integers(0, 3000, (b, a_cap)).astype(np.int32)
    a_qpos = rng.integers(0, 900, (b, a_cap)).astype(np.int32)
    n_hits = np.array([a_cap, 0, 40, 77, 1], np.int32)
    prev_key = (rng.integers(0, 2, (b, p_cap)).astype(np.uint32) << 31) | 3
    prev_tpos = rng.integers(0, 3000, (b, p_cap)).astype(np.int32)
    prev_qpos = rng.integers(0, 900, (b, p_cap)).astype(np.int32)
    n_prev = np.array([0, p_cap, 3, 0, 5], np.int32)
    target_rank = rng.permutation(n_seq).astype(np.int32)
    q_rank = np.array([-1, 2, 3, 5, 0], np.int32)  # -1: sorts before all
    kw = dict(span=prm["q_span"], max_dist_t=prm["max_dist_t"],
              max_dist_q=prm["max_dist_q"], bw=prm["bw"],
              max_iter=prm["max_iter"], chn_pen_gap=prm["chn_pen_gap"],
              chn_pen_skip=prm["chn_pen_skip"], all_vs_all=True)
    slot_valid = np.arange(a_cap)[None, :] < n_hits[:, None]
    want = jstep.merge_sort_fill(
        *(jnp.asarray(x) for x in (a_key, a_tpos, a_qpos, slot_valid, n_hits,
                                   prev_key, prev_tpos, prev_qpos, n_prev,
                                   q_rank, target_rank)), **kw)
    got = tstep.merge_sort_fill(
        *(torch.from_numpy(x) for x in (a_key.astype(np.int64), a_tpos, a_qpos,
                                        n_hits, prev_key.astype(np.int64),
                                        prev_tpos, prev_qpos, n_prev, q_rank,
                                        target_rank)), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype) if g.dtype == torch.int32
                                      else g.numpy(), w)
    kept = (target_rank[tid] > q_rank[:, None]) & slot_valid
    np.testing.assert_array_equal(got[3].numpy(), kept.sum(1) + n_prev)
    assert 0 < kept.sum() < slot_valid.sum()  # the filter dropped some, not all


def _records(results):
    """Every field of every record, without the wall-clock mt:f tag."""
    return [(r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       m.tags.split("\t", 1)[1]) for m in r.records])
            for r in results]


@pytest.fixture(scope="module")
def ava_runs():
    """Both engines on the fixture, on the host tail and on the forced
    device tail: {(package, tail): (index, records)}."""
    reads = ava_fixture_reads()
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for tail in ("host", "device"):
            if tail == "device":
                mp.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
            else:
                mp.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
            io, mo = options("ava-viral")
            mo.max_anchors_per_read = 512
            index = build_index_from_signals(reads, None, io)
            eng = MappingEngine(index, mo, device="cpu")
            assert eng.device_tail == (tail == "device")
            out["torch", tail] = (index, _records(eng.map_batch(reads)))
            jio, jmo = jcfg.IndexOptions(), jcfg.MapOptions()
            jcfg.set_preset("ava-viral", jio, jmo)
            jmo.max_anchors_per_read = 512
            jeng = JaxEngine(jax_build(reads, None, jio), jmo)
            out["jax", tail] = (None, _records(jeng.map_batch(reads)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("tail", ["host", "device"])
def test_ava_records_match_jax(ava_runs, tail):
    got, want = ava_runs["torch", tail][1], ava_runs["jax", tail][1]
    assert got == want
    assert sum(m[8] for _, recs in got for m in recs) >= 3


def _overlaps(index, recs):
    return [(name, index.seq_names[m[1]]) for name, rs in recs for m in rs if m[8]]


@pytest.mark.parametrize("tail", ["host", "device"])
def test_ava_properties(ava_runs, tail):
    """tests/test_ava.py's four properties on the port: a signal-target
    index of the 5 reads; each reported pair has the query's name before
    the target's (so no self overlaps); at least 2 of the 4 adjacent pairs
    found; at least 3 mapped records in all."""
    index, recs = ava_runs["torch", tail]
    assert index.sig_target and index.n_seq == 5
    overlaps = _overlaps(index, recs)
    assert all(q < t for q, t in overlaps)
    adjacent = {(f"read_{i:02d}", f"read_{i + 1:02d}") for i in range(4)}
    assert len(set(overlaps) & adjacent) >= 2, sorted(set(overlaps))
    assert len(overlaps) >= 3


def test_ava_cli_matches_jax(tmp_path):
    """`-x ava-viral --sig-target -d` builds the index from the reads; both
    CLIs then map the reads to it with the same PAF columns 1-12."""
    write_sig_npz(str(tmp_path / "reads.sig.npz"), ava_fixture_reads())
    reads = str(tmp_path / "reads.sig.npz")
    idx = str(tmp_path / "ava.rhi.npz")
    assert torch_cli.main(["-x", "ava-viral", "--sig-target", "-d", idx, reads,
                           "--device", "cpu"]) == 0
    args = ["-x", "ava-viral", "--max-anchors", "512", idx, reads]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax.paf")]) == 0
    assert torch_cli.main(args + ["--device", "cpu",
                                  "-o", str(tmp_path / "torch.paf")]) == 0
    cols = [[line.split("\t")[:12] for line in Path(tmp_path / f).read_text().splitlines()]
            for f in ("jax.paf", "torch.paf")]
    assert cols[0] == cols[1]
    assert sum(r[5] != "*" for r in cols[1]) >= 3
