"""The kernel bounds (rawhash_tpu_torch/profiling/bounds.py): each class of
work at its own H100 rate, and K1's pair counts against a pair-by-pair walk
of each anchor's in-band suffix through chain_fill.cuh's per-slot score."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.profiling import bounds  # noqa: E402
from rawhash_tpu_torch.profiling.bounds import (  # noqa: E402
    FILL_COST, bound, fill_ops, fill_work,
)
from rawhash_tpu_torch.profiling.fill_loop_overhead import probe_bound  # noqa: E402
from rawhash_tpu_torch.synthetic import options  # noqa: E402

HZ = 1.98e9
INT32_PER_S = 132 * 64 * HZ


@pytest.fixture
def boost_clock(monkeypatch):
    """The bounds at the data sheet's boost clock, whatever card is here."""
    monkeypatch.setattr(bounds, "sm_clock", lambda: (HZ, "data sheet boost clock"))


@pytest.mark.parametrize("k_ops,ms", [(2, 0.29), (20, 2.06), (60, 5.98)])
def test_probe_bound_at_the_int32_rate(boost_clock, k_ops, ms):
    got = probe_bound(100_000, k_ops, 64, 256)
    want = 64 * 256 * (k_ops + 1) * 100_000 / INT32_PER_S * 1e3
    assert got["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert got["bound_ms"] == pytest.approx(ms, rel=0.03)
    assert got["bound_class"] == "int32"


@pytest.mark.parametrize("ops,by", [
    ({}, "bytes"),
    ({"int32": 1e9}, "int32"),
    ({"int32": 1e9, "fp32": 1.9e9}, "int32"),
    ({"int32": 1e9, "fp32": 2.1e9}, "fp32"),
    ({"int32": 1e9, "cvt": 0.26e9}, "cvt"),
])
def test_bound_is_the_slowest_class(boost_clock, ops, by):
    got = bound(1e6, **ops)
    times = {"bytes": 1e6 / 3.35e12 * 1e3}
    times.update({c: n / (132 * {"fp32": 128, "int32": 64, "cvt": 16}[c] * HZ) * 1e3
                  for c, n in ops.items()})
    assert got["bound_class"] == by
    assert got["bound_ms"] == pytest.approx(max(times.values()), rel=1e-12)


def _walk(key, tpos, qpos, n_anchors, q_span, max_dist_t, max_dist_q, bw,
          max_iter, **_):
    """K1's pairs counted one at a time: each anchor's window scanned from
    its nearest predecessor back to the first one out of band, each pair in
    band followed through rh_slot and rh_score."""
    mdt, mdq = max(max_dist_t, bw), max(max_dist_q, bw)
    c = dict.fromkeys((*FILL_COST, "unsorted"), 0)
    for r in range(key.shape[0]):
        for i in range(min(int(n_anchors[r]), key.shape[1])):
            for j in range(i - 1, max(0, i - max_iter) - 1, -1):
                c["tested"] += 1
                dr = int(tpos[r, i]) - int(tpos[r, j])
                if not (key[r, i] == key[r, j] and 0 <= dr <= mdt):
                    break
                c["in_band"] += 1
                dq = int(qpos[r, i]) - int(qpos[r, j])
                if dq <= 0 or dq > mdq or dr == 0 or dr > mdq:
                    continue
                dd = abs(dr - dq)
                if dd > bw:
                    continue
                c["scored"] += 1
                if dd != 0 or min(dr, dq) > q_span:
                    c["penalised"] += 1
                c["logged"] += dd != 0
    return c


@pytest.mark.parametrize("preset", ["viral", "sensitive"])
def test_fill_work_counts_every_pair_as_the_score_does(preset):
    rng = np.random.default_rng(9)
    b, n = 3, 90
    prm = dict(fill_params(*options(preset)), max_iter=24)
    key = np.sort(rng.integers(0, 3, (b, n)), axis=1).astype(np.int32)
    tpos = np.sort(rng.integers(0, 6 * prm["max_dist_t"], (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 2 + rng.integers(-30, 30, (b, n))).astype(np.int32)
    tpos[:, 40] = tpos[:, 39]  # dr == 0
    n_anchors = np.array([n, 57, 0], np.int32)
    want = _walk(key, tpos, qpos, n_anchors, **prm)
    got = fill_work(*(torch.from_numpy(a) for a in (key, tpos, qpos, n_anchors)),
                    **prm)
    assert got == want
    assert 0 < want["logged"] < want["penalised"] <= want["scored"] < want["in_band"] < want["tested"]
    # one test past the suffix at most for each live anchor
    assert want["tested"] - want["in_band"] <= int(np.minimum(n_anchors, n).sum())
    ops = fill_ops(got)
    assert ops["cvt"] == 3 * got["penalised"] + 2 * got["logged"]
    assert ops["int32"] == sum(c.get("int32", 0) * got[k] for k, c in FILL_COST.items())


def test_fill_work_counts_in_band_pairs_past_the_suffix():
    """Inputs out of (key, tpos) order: the pairs in band that a scan of the
    suffix would miss are counted apart, so a caller can refuse the bound."""
    prm = dict(fill_params(*options("sensitive")), max_iter=8)
    key = np.zeros((1, 6), np.int32)
    tpos = np.array([[100, 110, 5000, 120, 130, 140]], np.int32)
    qpos = tpos // 2
    n_anchors = np.array([6], np.int32)
    got = fill_work(*(torch.from_numpy(a) for a in (key, tpos, qpos, n_anchors)),
                    **prm)
    # anchors 3-5 reach 0 and 1 only past anchor 2 (out of band): 2 + 2 + 2
    assert got["unsorted"] == 6
    assert got["in_band"] - got["unsorted"] == _walk(key, tpos, qpos, n_anchors, **prm)["in_band"]
