"""The kernel bounds (rawhash_tpu_torch/profiling/bounds.py): each class of
work at its own H100 rate, K1's pair counts against a pair-by-pair walk
of each anchor's in-band suffix through chain_fill.cuh's per-slot score,
and the backtrack's work against a step-by-step count of its algorithm."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.profiling import bounds  # noqa: E402
from rawhash_tpu_torch.profiling.bounds import (  # noqa: E402
    BACKTRACK_COST, FILL_COST, backtrack_bytes, backtrack_ops, backtrack_work,
    bound, fill_ops, fill_work,
)
from rawhash_tpu_torch.profiling.fill_loop_overhead import probe_bound  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    options, random_chains, sparse_anchors,
)

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


@pytest.mark.parametrize("w,k_ops,n_iter,by", [
    (64, 20, 1000, "critical_path"),  # the entry point's shape: 2 slots a lane
    (1, 0, 10, "critical_path"),  # one slot: the column max is the REDUX alone
    (200, 2, 7, "critical_path"),  # 7 slots a lane: a 3-deep lane max
    (4096, 20, 1000, "int32"),  # past the register ring, the rate binds
])
def test_probe_critical_path_class(boost_clock, w, k_ops, n_iter, by):
    """Given the card's latencies (cycles) and the clock, the critical path
    is n_iter x ((k_ops + ceil(log2 ceil(W/32))) x the step + the REDUX),
    and the bound is the largest class."""
    lat = {"viaddmnmx": 4.5, "redux": 27.0}
    got = probe_bound(n_iter, k_ops, w, 256, lat=lat)
    depth = {1: 0, 64: 1, 200: 3, 4096: 7}[w]
    cycles = n_iter * ((k_ops + depth) * 4.5 + 27.0)
    want = {"bytes": 8 * w * 256 / 3.35e12 * 1e3,
            "int32": w * 256 * (k_ops + 1) * n_iter / INT32_PER_S * 1e3,
            "critical_path": cycles / HZ * 1e3}
    assert got["class_ms"] == pytest.approx(want, rel=1e-12)
    assert got["bound_class"] == by
    assert got["bound_ms"] == pytest.approx(max(want.values()), rel=1e-12)
    assert bound(1e6, critical_path=cycles)["class_ms"]["critical_path"] == \
        pytest.approx(cycles / HZ * 1e3, rel=1e-12)


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


def _backtrack_steps(f, p, n_anchors, tpos, qpos, *, min_cnt, min_sc, max_drop,
                     k_cap, **_):
    """The backtrack's work counted one step at a time (mg_chain_backtrack,
    lchain.c:95-194), per row: candidates visited, skipped as claimed,
    walk-A steps, claim steps, kept chains, anchors kept."""
    rows = []
    for r in range(f.shape[0]):
        m = min(int(n_anchors[r]), f.shape[1])
        fr, pr = [int(x) for x in f[r]], [int(x) for x in p[r]]
        order = sorted((fr[i], i) for i in range(m) if fr[i] >= min_sc)
        claimed = set()
        c = dict.fromkeys(("candidates", "skipped", "walk_steps",
                           "claim_steps", "kept", "v_writes"), 0)
        for zsc, idx in reversed(order):
            c["candidates"] += 1
            if idx in claimed:
                c["skipped"] += 1
                continue
            i, end_i, max_s, cbest, step = idx, idx, 0, 0, 0
            while True:
                step += 1
                c["walk_steps"] += 1
                ni = pr[i]
                s = zsc if ni < 0 else zsc - fr[ni]
                if s > max_s:
                    max_s, end_i, cbest = s, ni, step
                elif max_s - s > max_drop:
                    break
                if ni < 0 or ni in claimed:
                    break
                i = ni
            j = idx
            while j != end_i:
                claimed.add(j)
                c["claim_steps"] += 1
                j = pr[j]
            if max_s >= min_sc and cbest > 0 and cbest >= min_cnt and c["kept"] < k_cap:
                c["kept"] += 1
                c["v_writes"] += cbest
        rows.append(c)
    return rows


def _sparse_chains(seed, b, n):
    prm = fill_params(*options("sensitive"))
    key, tpos, qpos, n_anchors = (
        torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
        for x in sparse_anchors(seed, b, n))
    f, p = chain_fill_batch(key, tpos, qpos, n_anchors, **prm)
    return f.numpy(), p.numpy(), n_anchors.numpy(), tpos.numpy(), qpos.numpy()


@pytest.mark.parametrize("rows,k_cap", [("random", 64), ("random", 3),
                                        ("sparse", 1024)])
def test_backtrack_work_counts_every_step(rows, k_cap):
    """backtrack_work (the header's serial algorithm, g++) against a count
    of each visit and step, and the bound's bytes and operations from it."""
    if rows == "random":
        args = random_chains(5, 3, 2000, 80, min_sc=15)
    else:
        args = _sparse_chains(7, 2, 1500)
    prm = dict(min_cnt=2, min_sc=15, max_drop=500, k_cap=k_cap, q_span=13)
    got = backtrack_work(*(torch.from_numpy(np.asarray(a)) for a in args), **prm)
    want = _backtrack_steps(*args, **prm)
    for k in ("candidates", "skipped", "walk_steps", "claim_steps", "kept",
              "v_writes"):
        assert got[k] == sum(c[k] for c in want), k
    assert got["serial_steps_max"] == max(
        c["candidates"] + c["walk_steps"] + c["claim_steps"] for c in want)
    assert got["live"] == int(np.minimum(args[2], args[0].shape[1]).sum())
    assert 0 < got["skipped"] < got["candidates"] and got["kept"] > 0
    assert got["p_reads"] <= min(got["walk_steps"], got["live"])
    assert backtrack_ops(got)["int32"] == sum(
        per * got[k] for k, per in BACKTRACK_COST.items())
    assert backtrack_bytes(got, 3) > 4 * got["live"]


@pytest.mark.parametrize("n", [1, 16, 17, 33, 256, 4000, 4001, 28672])
@pytest.mark.parametrize("kind", ["cumsum", "sum"])
def test_scan_adds_count_the_levels(n, kind):
    """The ordered sums' adds, counted level by level as the plain versions
    make them: one per value of every padded level, and the cumsum's
    down-sweep two per value below the top."""
    block = 16 if kind == "cumsum" else 32
    want, level, below = 0, n, 0
    while level > block:
        nxt = -(-level // block)
        want += nxt * block
        below += level
        level = nxt
    want += level + (2 * below if kind == "cumsum" else 0)
    assert bounds.scan_adds(n, kind) == want
    assert bounds.scan_adds(n, kind) >= n


def test_event_kernel_bounds(boost_clock):
    """The serial scans are bounded by their critical path at the main
    path's shapes, the ordered sums by their bytes."""
    lat = {"viaddmnmx": 4.0, "fsetp_plop3_sel": 14.0}
    got = bounds.peaks_bound(256, 4000, 3990, lat)
    assert got["bound_class"] == "critical_path"
    assert got["bound_ms"] == pytest.approx(3990 * (4.0 + 14.0) / HZ * 1e3)
    assert got["class_ms"]["bytes"] == pytest.approx(
        (16 * 256 * 4000 + 4 * 256) / 3.35e12 * 1e3)
    assert bounds.peaks_bound(256, 4000, 3990)["bound_class"] == "bytes"
    got = bounds.diff_filter_bound(256, 768, 700, lat)
    assert got["bound_class"] == "critical_path"
    assert got["bound_ms"] == pytest.approx(700 * bounds.DIFF_CHAIN * 4.0 / HZ * 1e3)
    for kind, out in (("cumsum", 4000), ("sum", 1)):
        got = bounds.scan_bound(256, 4000, kind)
        assert got["bound_class"] == "bytes"
        assert got["bound_ms"] == pytest.approx(4 * 256 * (4000 + out) / 3.35e12 * 1e3)


@pytest.mark.parametrize("lat,cycles", [
    ({"viaddmnmx": 4.0, "fsetp_plop3_sel": 14.0}, 18.0),
    ({"viaddmnmx": 4.119710286458333, "fsetp_plop3_sel": 13.0, "redux": 44.0}, 17.119710286458333),
])
def test_peaks_chain_priced_by_class(boost_clock, lat, cycles):
    """K5's chain a position is priced by instruction class at the card's
    latencies: one ALU step (the drop) and one compare -> predicate op ->
    select; classes the chain does not name cost nothing."""
    assert bounds.chain_cycles(bounds.PEAKS_CHAIN, lat) == pytest.approx(cycles)
    got = bounds.peaks_bound(256, 28672, 28672, lat)
    assert got["class_ms"]["critical_path"] == pytest.approx(28672 * cycles / HZ * 1e3)


@pytest.mark.parametrize("l,e_cap,sig_bytes", [(4000, 768, 2), (28672, 16384, 4)])
def test_events_stage_bound(boost_clock, l, e_cap, sig_bytes):
    """The events stage's three kernels: the stage's inputs and outputs
    alone (the signal, row lengths and carry read; the events, their counts
    and the carry written), the kernels' intermediates in global memory
    beside them; with the card's latencies, the detector's chain, which
    bounds the stage as it bounds K5."""
    lat = {"viaddmnmx": 4.0, "fsetp_plop3_sel": 14.0}
    got = bounds.events_stage_bound(256, l, e_cap, l, sig_bytes, lat)
    assert got["class_ms"]["bytes"] == pytest.approx(
        256 * (l * sig_bytes + 4 * e_cap + 4 + 12 + 4 + 12) / 3.35e12 * 1e3)
    assert got["staged_bytes"] == 256 * l * 40
    assert got["class_ms"]["critical_path"] == pytest.approx(
        bounds.peaks_bound(256, l, l, lat)["class_ms"]["critical_path"])
    assert got["bound_class"] == "critical_path"
    assert bounds.events_stage_bound(256, l, e_cap, l, sig_bytes)["bound_class"] == "bytes"


def test_peaks_chain_needs_the_measured_classes():
    """A latency table without the compare-select chain cannot price K5."""
    with pytest.raises(KeyError):
        bounds.peaks_bound(256, 4000, 4000, {"viaddmnmx": 4.0})


@pytest.mark.parametrize("kind,out", [("cumsum", 4001), ("sum", 1)])
def test_scan_bound_of_a_value_and_its_square(boost_clock, kind, out):
    """One pass over x and x * x reads x once and writes both outputs (the
    prefix sums with their leading zero): still bound by its bytes."""
    got = bounds.scan_bound(256, 4000, kind, squares=True, lead_zero=True)
    assert got["bound_class"] == "bytes"
    assert got["bound_ms"] == pytest.approx(4 * 256 * (4000 + 2 * out) / 3.35e12 * 1e3)
    assert got["class_ms"]["fp32"] == pytest.approx(
        256 * (2 * bounds.scan_adds(4000, kind) + 4000) / (132 * 128 * HZ) * 1e3)


def test_scan_stamp_phases():
    """The K6 probe's reading of its stamps (profiling/kernel_time.py): a
    launch's span and start skew from the global timer, warps an SM, and
    each phase from the warp's previous stamp (a warp with no round of its
    own times level 0 from its entry); warps that never ran are left out."""
    from rawhash_tpu_torch.profiling.kernel_time import STAMPS, _phases

    st = np.zeros((4, STAMPS), np.int64)
    st[0] = [1000, 100, 300, 700, 720, 900, 0, 1500, 3]
    st[1] = [1010, 200, 0, 600, 650, 0, 0, 1400, 3]
    st[2] = [1020, 50, 150, 450, 460, 0, 0, 1300, 5]
    got = _phases(st)
    assert (got["warps"], got["sms"], got["warps_per_sm"]) == (3, 2, [1, 2])
    assert (got["span_ns"], got["start_skew_ns"], got["warp_ns_median"]) == (500, 20, 390.0)
    assert got["first_round_cycles"] == {"median": 150.0, "max": 200.0}
    assert got["level0_cycles"] == {"median": 400.0, "max": 400.0}
    assert got["barrier_cycles"] == {"median": 20.0, "max": 50.0}
    assert got["levels_cycles"] == {"median": 180.0, "max": 180.0}
    assert "down_cycles" not in got


def _xla_adds_by_walk(n: int) -> int:
    """The adds of the plain version's `_cumsum` order on n values, walked a
    value at a time as csrc/dtw_banded.cuh's RhXlaLevel takes them: a block's
    first value is copied, every other one added; a level of more than 16
    values also adds each value to its blocks' prefix, and passes its block
    totals up."""
    if n <= 16:
        return max(n - 1, 0)
    blocks = -(-n // 16)
    inner = sum(min(16, n - 16 * g) - 1 for g in range(blocks))
    return inner + n + _xla_adds_by_walk(blocks)


@pytest.mark.parametrize("n", [1, 9, 16, 17, 33, 256, 257, 513, 1025, 4097, 65537])
def test_xla_adds_count_the_levels(n):
    assert bounds.xla_adds(n) == _xla_adds_by_walk(n)
    assert bounds.xla_adds(n) >= n - 1


def test_dtw_bound(boost_clock):
    """K8 at the dtw cell's widest call (36401 pairs of up to 180 columns,
    width 33): its adds and mins a slot a column over the pairs' own
    columns; the bytes of the pairs' values; the longest pair's chain of
    columns at the ALU latency, log2(width) minimum steps a column."""
    lat = {"viaddmnmx": 4.0, "fsetp_plop3_sel": 14.0}
    pairs, max_len, width, columns, values = 36401, 180, 33, 3_500_000, 6_000_000
    got = bounds.dtw_bound(pairs, max_len, width, lat, columns=columns, values=values)
    per_slot = columns * width
    assert got["class_ms"]["fp32_minmax"] == pytest.approx(
        4 * per_slot / (132 * 64 * HZ) * 1e3)
    assert got["class_ms"]["fp32"] == pytest.approx(
        (4 * per_slot + columns * bounds.xla_adds(width)) / (132 * 128 * HZ) * 1e3)
    assert got["class_ms"]["bytes"] == pytest.approx(
        (4 * values + 16 * pairs) / 3.35e12 * 1e3)
    assert got["class_ms"]["critical_path"] == pytest.approx(
        max_len * (7 + 6) * 4.0 / HZ * 1e3)
    assert got["bound_class"] == "fp32_minmax"
    # without the data's own counts, every pair runs max_len columns
    full = bounds.dtw_bound(pairs, max_len, width)
    assert full["class_ms"]["fp32_minmax"] == pytest.approx(
        4 * pairs * max_len * width / (132 * 64 * HZ) * 1e3)
    assert "critical_path" not in full["class_ms"]
