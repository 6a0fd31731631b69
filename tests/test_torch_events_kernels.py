"""The events and sketch kernels' own logic on the CPU: the headers of the
peak detector (csrc/events_peaks.cuh), the ordered sums
(csrc/ordered_scan.cuh), the diff filter (csrc/diff_filter.cuh) and the
events stage's row programs (csrc/events_fused.cuh), built for the host
with g++ (csrc/*_host.cpp), held bit for bit against the plain PyTorch
versions on seeded inputs and edge cases; the plain versions held bit for
bit against the JAX package's functions on identical inputs; and the
wrappers' checks.  The kernels themselves run on a card in
test_torch_cuda.py."""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu.signal import events as jev  # noqa: E402
from rawhash_tpu.sketch import device as jsk  # noqa: E402
from rawhash_tpu_torch._build import load_host_library  # noqa: E402
from rawhash_tpu_torch.signal import events as tev  # noqa: E402
from rawhash_tpu_torch.sketch import device as tsk  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    event_tstats, options, peak_handoff_tstats, signal_chunk,
)

P = ctypes.c_void_p
VIRAL = options("viral")
# the detector's parameters as detect_events_batch passes them
PEAKS = dict(t1=VIRAL[1].threshold1, t2=VIRAL[1].threshold2,
             w1=VIRAL[1].window_length1, w2=VIRAL[1].window_length2,
             peak_height=VIRAL[1].peak_height)
DIFF = VIRAL[0].diff


def _lib(name):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    return load_host_library(name)


def _ptr(a):
    return a.ctypes.data_as(P)


def host_peaks(ts1, ts2, n_sig, *, t1, t2, w1, w2, peak_height):
    """rh_peaks_host: the kernel's per-read step (events_peaks.cuh)."""
    lib = _lib("events_peaks")
    lib.rh_peaks_host.argtypes = [P] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [
        ctypes.c_int] * 3
    b, l = ts1.shape
    out = np.full((b, 2 * l), 7, np.int32)
    lib.rh_peaks_host(_ptr(ts1), _ptr(ts2), _ptr(n_sig), _ptr(out), b, l, t1, t2,
                      peak_height, w1, w1 // 2, w2 // 2)
    return out


def host_scan(x, which, *, squares=False, lead=False):
    """rh_prefix_host / rh_sum_host over x's rows (any row stride), as the
    kernels run them (ordered_scan.cuh, the kernels' plan).  which "cumsum"
    gives [B, lead + L] prefix sums, "sum" [B] sums; with squares, the pair
    (of x, of x * x)."""
    lib = _lib("ordered_scan")
    b, l = x.shape
    if which == "cumsum":
        fn = lib.rh_prefix_host
        fn.argtypes = [P, ctypes.c_longlong, P, P, ctypes.c_longlong] + [ctypes.c_int] * 3
        shape = (b, l + lead)
    else:
        fn = lib.rh_sum_host
        fn.argtypes = [P, ctypes.c_longlong, P, P] + [ctypes.c_int] * 2
        shape = (b,)
    fn.restype = ctypes.c_int
    out = np.full(shape, np.nan, np.float32)
    out_sq = np.full(shape, np.nan, np.float32) if squares else None
    sq_ptr = _ptr(out_sq) if squares else None
    if which == "cumsum":
        rc = fn(_ptr(x), x.strides[0] // 4, _ptr(out), sq_ptr, l + lead, int(lead), b, l)
    else:
        rc = fn(_ptr(x), x.strides[0] // 4, _ptr(out), sq_ptr, b, l)
    assert rc == 0
    return (out, out_sq) if squares else out


def scan_plan(l, which, squares):
    """The kernels' plan of a row of l values (rh_scan_plan_host): {g: warps
    a row, rows: rows a block, res: tiles a warp stages at a time, rounds:
    rounds a row, smem: bytes a block}."""
    lib = _lib("ordered_scan")
    lib.rh_scan_plan_host.argtypes = [ctypes.c_int] * 3 + [P]
    out = np.zeros(5, np.int64)
    assert lib.rh_scan_plan_host(l, int(which == "cumsum"), int(squares), _ptr(out)) == 1
    return dict(zip(("g", "rows", "res", "rounds", "smem"), map(int, out)))


def host_diff(events, n_ev, diff):
    """rh_diff_filter_host: the kernel's per-read step (diff_filter.cuh)."""
    lib = _lib("diff_filter")
    lib.rh_diff_filter_host.argtypes = [P] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
    b, e = events.shape
    keep = np.full((b, e), 7, np.uint8)
    lib.rh_diff_filter_host(_ptr(events), _ptr(n_ev), _ptr(keep), b, e, diff)
    assert set(np.unique(keep)) <= {0, 1}
    return keep.astype(bool)


def plain_peaks(ts1, ts2, n_sig, **prm):
    return tev._gen_peaks_plain(torch.from_numpy(ts1), torch.from_numpy(ts2),
                                torch.from_numpy(n_sig), **prm).numpy()


def _signal_tstats(rng, b, l, n_sig):
    return event_tstats(rng, b, l, n_sig, PEAKS["w1"], PEAKS["w2"])


def _edge_tstats(rng, b, l):
    """Rows of values on the comparisons' edges: exactly at the thresholds,
    at peak_height above a valley, FLT_MAX, zeros and plateaus."""
    f = np.float32
    vals = np.array([0.0, f(0.4), f(0.8), f(3.5), f(3.9), f(4.0), f(4.4), f(7.9),
                     f(8.3), f(3.5) + f(0.4), 3.4028235e38], np.float32)
    ts1 = vals[rng.integers(0, len(vals), (b, l))]
    ts2 = vals[rng.integers(0, len(vals), (b, l))]
    # plateaus: a value held for a few positions
    ts1[:, 1::3] = ts1[:, 0:-1:3][:, : ts1[:, 1::3].shape[1]]
    return ts1.astype(np.float32), ts2.astype(np.float32)


@pytest.mark.parametrize("seed,b,l", [(1, 9, 4000), (2, 5, 1001), (3, 4, 33),
                                      (4, 3, 28672)])
@pytest.mark.parametrize("inputs", ["signal", "edges"])
def test_peaks_header_matches_plain(seed, b, l, inputs):
    """The kernel's step over every position equals the plain detector, on
    rows of different lengths: n_sig 0, under 2 w2, a few, all of L and
    past it."""
    rng = np.random.default_rng(seed)
    n_sig = rng.integers(0, l + 1, b).astype(np.int32)
    n_sig[:3] = [l, 0, min(l, 2 * PEAKS["w2"] - 1)]
    if b > 3:
        n_sig[3] = l + 5  # past L: the row is live to its end
    if inputs == "signal":
        ts1, ts2 = _signal_tstats(rng, b, l, np.minimum(n_sig, l))
    else:
        ts1, ts2 = _edge_tstats(rng, b, l)
    got = host_peaks(ts1, ts2, n_sig, **PEAKS)
    want = plain_peaks(ts1, ts2, n_sig, **PEAKS)
    np.testing.assert_array_equal(got, want)
    assert (want[0] >= 0).sum() > 0 and (want[1] == -1).all()


def test_peaks_header_emits_at_the_last_position():
    """A peak that the short detector emits at the last live position (the
    signal drops there); and the same row cut one position earlier, where
    it is never emitted."""
    l = 40
    ts1 = np.zeros((2, l), np.float32)
    ts1[:, 30] = 9.0  # the peak, w1 // 2 = 1 position before the drop
    ts1[:, 31:] = 9.0
    ts1[:, 32] = 0.0  # the drop past peak_height, at the last live position
    ts2 = np.full((2, l), 5.0, np.float32)
    ts2[:, 10] = 6.0
    n_sig = np.array([33, 32], np.int32)
    got = host_peaks(ts1, ts2, n_sig, **PEAKS)
    want = plain_peaks(ts1, ts2, n_sig, **PEAKS)
    np.testing.assert_array_equal(got, want)
    assert want[0, 2 * 32] == 30 and want[1, 2 * 32] == -1


def test_peaks_parameters_reach_the_header():
    """Other thresholds, windows and peak heights give the plain version's
    emissions."""
    rng = np.random.default_rng(8)
    b, l = 6, 3000
    n_sig = rng.integers(100, l + 1, b).astype(np.int32)
    ts1, ts2 = _signal_tstats(rng, b, l, n_sig)
    for prm in (dict(t1=3.0, t2=2.5, w1=4, w2=12, peak_height=0.2),
                dict(t1=1.0, t2=6.0, w1=1, w2=2, peak_height=1.5)):
        np.testing.assert_array_equal(host_peaks(ts1, ts2, n_sig, **prm),
                                      plain_peaks(ts1, ts2, n_sig, **prm))


def jax_peaks(ts1, ts2, n_sig, *, t1, t2, w1, w2, peak_height):
    return np.asarray(jev._gen_peaks(jnp.asarray(ts1), jnp.asarray(ts2),
                                     jnp.asarray(n_sig), t1, t2, w1, w2, peak_height))


def test_peaks_handoff_across_tiles():
    """The short detector's mask set at a tile's last positions reaches into
    the next tile, and a long peak pends across a tile edge: the host build
    of the two steps (a tile of short steps, then the tile's long steps)
    equals the plain detector and the JAX package's _gen_peaks."""
    ts1, ts2, n_sig = peak_handoff_tstats()
    got = host_peaks(ts1, ts2, n_sig, **PEAKS)
    want = plain_peaks(ts1, ts2, n_sig, **PEAKS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jax_peaks(ts1, ts2, n_sig, **PEAKS))
    long0, long1 = want[0, 1::2], want[1, 1::2]
    assert (long0 != long1).any()  # the mask across the edge changed row 0
    assert want[0, 0::2].max() == 30  # the short peak, emitted
    assert (want[2, 1::2][64:] >= 0).any() and (want[2, 1::2][:64] < 0).all()
    assert (want[3, 0::2] >= 0).any()


@pytest.mark.parametrize("l", [31, 32, 33, 95, 4000])
def test_peaks_mixed_lengths_in_one_warp(l):
    """Reads of n_sig 0, 1, l and past l, and random ones, in one 32-read
    warp and past it (b = 37), on tiles that end before, at and after l."""
    rng = np.random.default_rng(l)
    b = 37
    n_sig = rng.integers(0, l + 1, b).astype(np.int32)
    n_sig[:5] = [0, 1, l, l + 7, min(l, 33)]
    n_sig[32:35] = [1, 0, l]
    ts1, ts2 = _signal_tstats(rng, b, l, np.minimum(n_sig, l))
    got = host_peaks(ts1, ts2, n_sig, **PEAKS)
    want = plain_peaks(ts1, ts2, n_sig, **PEAKS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jax_peaks(ts1, ts2, np.minimum(n_sig, l), **PEAKS))
    assert (want[0] == -1).all() and (want[1] == -1).all()


# lengths at each level's edge: 16^k +/- 1 (the prefix sum's blocks) and
# 32^k +/- 1 (the sum's windows), the events stage's 4000 and ava's 28672
SCAN_LENGTHS = [1, 5, 15, 16, 17, 31, 32, 33, 255, 256, 257, 1000, 1023, 1024, 1025,
                4000, 4001, 4095, 4096, 4097, 28671, 28672]


def _scan_rows(l):
    rng = np.random.default_rng(l)
    wide = rng.normal(0, 3, (6, l + 7)).astype(np.float32)
    wide[0, : min(l, 40)] = -0.0  # signed zeros in front
    return wide


@pytest.mark.parametrize("l", SCAN_LENGTHS)
def test_scan_header_matches_plain_and_jax(l):
    """The kernels' level order equals the plain ordered sums and XLA's CPU
    jnp.cumsum / jnp.sum bit for bit, on contiguous rows and on rows of a
    wider array (the kernels take a row stride)."""
    wide = _scan_rows(l)
    for x in (np.ascontiguousarray(wide[:, :l]), wide[:, 3:l + 3]):
        cum, tot = host_scan(x, "cumsum"), host_scan(x, "sum")
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(cum, tev.ordered_cumsum_plain(xt).numpy())
        np.testing.assert_array_equal(tot, tev.ordered_sum_plain(xt).numpy())
        np.testing.assert_array_equal(cum, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))
        np.testing.assert_array_equal(tot, np.asarray(jnp.sum(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("l", SCAN_LENGTHS)
def test_scan_pair_equals_two_single_calls(l):
    """One pass over a value and its square (with the prefix sum's leading
    zero) equals the two single calls, on the host build and on the plain
    side, and through them jnp.cumsum / jnp.sum of x and x * x."""
    x = _scan_rows(l)[:, 2:l + 2]
    xt = torch.from_numpy(x)
    sq = x * x
    cum, cum_sq = host_scan(x, "cumsum", squares=True, lead=True)
    tot, tot_sq = host_scan(x, "sum", squares=True)
    pad = np.zeros((x.shape[0], 1), np.float32)
    for got, want in ((cum, host_scan(x, "cumsum")), (cum_sq, host_scan(sq, "cumsum"))):
        np.testing.assert_array_equal(got, np.concatenate([pad, want], axis=1))
    np.testing.assert_array_equal(tot, host_scan(x, "sum"))
    np.testing.assert_array_equal(tot_sq, host_scan(sq, "sum"))
    plain_cum = tev.ordered_cumsum_plain(xt, squares=True, lead_zero=True)
    plain_tot = tev.ordered_sum_plain(xt, squares=True)
    for got, want in ((cum, plain_cum[0]), (cum_sq, plain_cum[1]), (tot, plain_tot[0]),
                      (tot_sq, plain_tot[1])):
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(cum_sq[:, 1:], np.asarray(jnp.cumsum(jnp.asarray(sq), axis=1)))
    np.testing.assert_array_equal(tot_sq, np.asarray(jnp.sum(jnp.asarray(sq), axis=1)))
    assert (cum[:, 0] == 0).all() and (cum_sq[:, 0] == 0).all()


# lengths on each side of the plan's edges: one warp a row up to 8192
# values, 8 past them; a prefix sum's tiles kept for its down-sweep (4000,
# 8193, 16384) or its rounds copied again (6000, 8192, 16385, 28673)
PLAN_LENGTHS = [4000, 6000, 8191, 8192, 8193, 16384, 16385, 28673, 40000]


@pytest.mark.parametrize("l", PLAN_LENGTHS)
@pytest.mark.parametrize("strided", [False, True])
def test_scan_plan_paths(l, strided):
    """On each side of the plan's edges (warps a row, tiles kept or copied
    again), the host build of the kernels' layout, a value and its square
    with the prefix sum's leading zero, equals the plain versions bit for
    bit, on contiguous rows and on rows of a wider array."""
    wide = _scan_rows(l)
    x = wide[:, 1:l + 1] if strided else np.ascontiguousarray(wide[:, :l])
    plan = scan_plan(l, "cumsum", True)
    assert plan["g"] == (8 if l > 8192 else 1)
    xt = torch.from_numpy(x)
    got = (*host_scan(x, "cumsum", squares=True, lead=True), *host_scan(x, "sum", squares=True))
    want = (*tev.ordered_cumsum_plain(xt, squares=True, lead_zero=True),
            *tev.ordered_sum_plain(xt, squares=True))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_scan_plan_lengths_cover_both_paths():
    """PLAN_LENGTHS take each of the prefix sum's four paths: one warp or 8
    a row, tiles kept for the down-sweep or rounds copied again."""
    paths = set()
    for l in PLAN_LENGTHS:
        p = scan_plan(l, "cumsum", True)
        paths.add((p["g"], p["res"] < -(-p["rounds"] // p["g"])))
        assert p["smem"] <= 227 * 1024
    assert paths == {(1, False), (1, True), (8, False), (8, True)}


def _events(rng, b, e):
    ev = np.round(rng.normal(0, 1.0, (b, e)) / 0.05) * 0.05  # differences at diff
    ev = ev.astype(np.float32)
    n_ev = rng.integers(0, e + 1, b).astype(np.int32)
    n_ev[:3] = [0, 1, e][:b]
    return ev, n_ev


@pytest.mark.parametrize("seed,b,e", [(1, 9, 768), (2, 4, 33), (3, 3, 16384)])
def test_diff_filter_header_matches_plain(seed, b, e):
    """n_ev 0, 1 and E: event 0 is kept whenever n_ev > 0, whatever it is."""
    rng = np.random.default_rng(seed)
    ev, n_ev = _events(rng, b, e)
    ev[1, 0] = 0.0  # equal to the filter's starting value: kept all the same
    for diff in (DIFF, options("ava")[0].diff, 0.0):
        got = host_diff(ev, n_ev, diff)
        want = tsk._diff_filter_plain(torch.from_numpy(ev), torch.from_numpy(n_ev),
                                      diff).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[0].any() and got[1].tolist() == [True] + [False] * (e - 1)
        assert 0 < got[2].sum() <= e and (got[2].sum() == e) == (diff == 0.0)


@pytest.mark.parametrize("e", [1, 33, 768])
def test_diff_filter_tiles_at_their_edges(e):
    """The tile step at the tiles' edges: n_ev 0, 1, 31, 32, 33, 63 and E
    (and past E) in one group of 32 reads, and a second group of 8 whose
    reads are all short, so its bytes past its first tile are the fill's;
    event values on diff's edge."""
    rng = np.random.default_rng(e)
    edges = [0, 1, 31, 32, 33, 63, e, e + 5]
    b = 40
    ev, _ = _events(rng, b, e)
    n_ev = np.array([edges[i % len(edges)] for i in range(32)]
                    + list(rng.integers(0, 3, b - 32)), np.int32)
    for diff in (DIFF, 0.0):
        got = host_diff(ev, n_ev, diff)
        want = tsk._diff_filter_plain(torch.from_numpy(ev), torch.from_numpy(n_ev),
                                      diff).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(want.sum(1) > 0, np.minimum(n_ev, e) > 0)


@pytest.mark.parametrize("seed,b,l", [(1, 4, 4000), (2, 3, 257)])
def test_plain_peaks_match_jax(seed, b, l):
    """The plain detector equals the JAX package's _gen_peaks on identical
    t-statistics (the scan the kernel replaces)."""
    rng = np.random.default_rng(seed)
    n_sig = rng.integers(0, l + 1, b).astype(np.int32)
    n_sig[0] = l
    ts1, ts2 = _signal_tstats(rng, b, l, n_sig)
    ts1[1:, ::97] = np.float32(4.0)  # at the short threshold
    want = np.asarray(jev._gen_peaks(jnp.asarray(ts1), jnp.asarray(ts2),
                                     jnp.asarray(n_sig), PEAKS["t1"], PEAKS["t2"],
                                     PEAKS["w1"], PEAKS["w2"], PEAKS["peak_height"]))
    np.testing.assert_array_equal(plain_peaks(ts1, ts2, n_sig, **PEAKS), want)
    assert (want >= 0).sum() > 10


@pytest.mark.parametrize("seed,b,e", [(4, 6, 768), (5, 2, 16384)])
def test_plain_diff_filter_matches_jax(seed, b, e):
    rng = np.random.default_rng(seed)
    ev, n_ev = _events(rng, b, e)
    want = np.asarray(jsk._diff_filter(jnp.asarray(ev), jnp.asarray(n_ev), DIFF))
    got = tsk._diff_filter_plain(torch.from_numpy(ev), torch.from_numpy(n_ev),
                                 DIFF).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_on_cpu_tensors_take_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    rng = np.random.default_rng(11)
    n_sig = np.array([300, 0, 120], np.int32)
    ts1, ts2 = _signal_tstats(rng, 3, 300, n_sig)
    ev, n_ev = _events(rng, 3, 200)
    before = [f.launches for f in (tev._gen_peaks, tev.ordered_cumsum,
                                   tev.ordered_sum, tsk._diff_filter)]
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tev._gen_peaks(t(ts1), t(ts2), t(n_sig), **PEAKS).numpy(),
        plain_peaks(ts1, ts2, n_sig, **PEAKS))
    np.testing.assert_array_equal(tev.ordered_cumsum(t(ts1)).numpy(),
                                  host_scan(ts1, "cumsum"))
    np.testing.assert_array_equal(tev.ordered_sum(t(ts1)).numpy(), host_scan(ts1, "sum"))
    np.testing.assert_array_equal(tsk._diff_filter(t(ev), t(n_ev), DIFF).numpy(),
                                  host_diff(ev, n_ev, DIFF))
    after = [f.launches for f in (tev._gen_peaks, tev.ordered_cumsum,
                                  tev.ordered_sum, tsk._diff_filter)]
    assert after == before


def _bad_peaks_inputs():
    ts = torch.zeros((4, 64), dtype=torch.float32)
    n = torch.zeros(4, dtype=torch.int32)
    return {
        "f64 tstat1": (ts.double(), ts, n),
        "f64 tstat2": (ts, ts.double(), n),
        "i64 n_sig": (ts, ts, n.long()),
        "transposed tstat1": (torch.zeros((64, 4)).t(), ts, n),
        "strided tstat2": (ts, torch.zeros((4, 128))[:, ::2], n),
        "short n_sig": (ts, ts, n[:3]),
        "1-D tstat1": (ts[0], ts[0], n),
    }


@pytest.mark.parametrize("case", list(_bad_peaks_inputs()))
def test_gen_peaks_rejects_wrong_dtype_or_layout(case):
    with pytest.raises(ValueError):
        tev._gen_peaks(*_bad_peaks_inputs()[case], **PEAKS)


@pytest.mark.parametrize("fn,options", [
    pytest.param("ordered_cumsum", {}, id="ordered_cumsum"),
    pytest.param("ordered_sum", {}, id="ordered_sum"),
    pytest.param("ordered_cumsum", {"squares": True, "lead_zero": True},
                 id="ordered_cumsum-squares-lead_zero"),
    pytest.param("ordered_cumsum", {"lead_zero": True}, id="ordered_cumsum-lead_zero"),
    pytest.param("ordered_sum", {"squares": True}, id="ordered_sum-squares")])
@pytest.mark.parametrize("case", ["f64", "transposed", "1-D", "3-D", "i32"])
def test_ordered_sums_reject_wrong_dtype_or_layout(fn, options, case):
    x = {"f64": torch.zeros((4, 64), dtype=torch.float64),
         "transposed": torch.zeros((64, 4)).t(),
         "1-D": torch.zeros(64),
         "3-D": torch.zeros((2, 4, 64)),
         "i32": torch.zeros((4, 64), dtype=torch.int32)}[case]
    with pytest.raises(ValueError):
        getattr(tev, fn)(x, **options)


def test_ordered_sums_take_strided_rows():
    """A row stride past the row's length is a layout the kernels take (the
    events stage passes such a slice)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 70)).astype(np.float32))
    np.testing.assert_array_equal(tev.ordered_cumsum(x[:, :64]).numpy(),
                                  host_scan(x[:, :64].numpy(), "cumsum"))


@pytest.mark.parametrize("case", ["f64 events", "i64 n_ev", "transposed events",
                                  "short n_ev"])
def test_diff_filter_rejects_wrong_dtype_or_layout(case):
    ev = torch.zeros((4, 64), dtype=torch.float32)
    n = torch.zeros(4, dtype=torch.int32)
    args = {"f64 events": (ev.double(), n), "i64 n_ev": (ev, n.long()),
            "transposed events": (torch.zeros((64, 4)).t(), n),
            "short n_ev": (ev, n[:2])}[case]
    with pytest.raises(ValueError):
        tsk._diff_filter(*args, DIFF)


# ---- the events stage's kernels (csrc/events_fused.cuh) ---------------------

# the detector's parameters as detect_events_batch takes them
STAGE = dict(window_length1=VIRAL[1].window_length1,
             window_length2=VIRAL[1].window_length2,
             threshold1=VIRAL[1].threshold1, threshold2=VIRAL[1].threshold2,
             peak_height=VIRAL[1].peak_height)
# windows of 1 and 2 positions: segments of 2 and 3 positions
SHORT = dict(window_length1=1, window_length2=2, threshold1=1.0, threshold2=2.0,
             peak_height=0.2)


def stage_plan(l, e_cap):
    """The words of each row program's scratch (rh_ev_plan_host), and
    whether each stages its rows in global memory (past a block's 227 KB of
    shared memory, as events_fused.cu decides)."""
    lib = _lib("events_fused")
    lib.rh_ev_plan_host.argtypes = [ctypes.c_int, ctypes.c_int, P]
    out = np.zeros(4, np.int64)
    lib.rh_ev_plan_host(l, e_cap, _ptr(out))
    assert [bool(4 * w > 227 * 1024) for w in out[:2]] == [not f for f in out[2:]]
    return [int(w) for w in out[:2]], [not f for f in out[2:]]


def host_stage(sig, slen, carry, e_cap, prm, emitted=None):
    """The events stage as events_fused.cu launches it, its kernels' logic
    on the host: rh_ev_norm_host, the detector (rh_peaks_host, or the given
    emissions), rh_ev_segments_host.  Returns (events, n_ev, sum, sum_sq,
    n) and the emissions, as numpy."""
    lib = _lib("events_fused")
    i = ctypes.c_int
    lib.rh_ev_norm_host.argtypes = [P, ctypes.c_longlong] + [P] * 11 + [i] * 4
    lib.rh_ev_segments_host.argtypes = [P] * 5 + [i] * 3
    b, l = sig.shape
    c_sum, c_sq, c_n = carry
    o_sum, o_sq = np.full(b, np.nan, np.float32), np.full(b, np.nan, np.float32)
    o_n, n_sig = np.full(b, -7, np.int32), np.full(b, -7, np.int32)
    normc, ts1, ts2 = (np.full((b, l), np.nan, np.float32) for _ in range(3))
    w1, w2 = prm["window_length1"], prm["window_length2"]
    lib.rh_ev_norm_host(_ptr(sig), sig.strides[0] // 4, _ptr(slen), _ptr(c_sum),
                        _ptr(c_sq), _ptr(c_n), _ptr(o_sum), _ptr(o_sq), _ptr(o_n),
                        _ptr(normc), _ptr(n_sig), _ptr(ts1), _ptr(ts2), b, l, w1, w2)
    if emitted is None:
        emitted = host_peaks(ts1, ts2, n_sig, t1=prm["threshold1"],
                             t2=prm["threshold2"], w1=w1, w2=w2,
                             peak_height=prm["peak_height"])
    ev, n_ev = np.full((b, e_cap), np.nan, np.float32), np.full(b, -7, np.int32)
    lib.rh_ev_segments_host(_ptr(emitted), _ptr(normc), _ptr(n_sig), _ptr(ev),
                            _ptr(n_ev), b, l, e_cap)
    return (ev, n_ev, o_sum, o_sq, o_n), emitted


def plain_stage(sig, slen, carry, e_cap, prm, emitted=None, monkeypatch=None):
    """detect_events_batch on CPU tensors (its detector's emissions replaced
    by the given ones), as numpy."""
    t = torch.from_numpy
    if emitted is not None:
        monkeypatch.setattr(tev, "_gen_peaks", lambda *a, **k: t(emitted))
    ev, n_ev, c = tev.detect_events_batch(t(sig), t(slen), tev.NormCarry(*map(t, carry)),
                                          e_cap=e_cap, **prm)
    return (ev.numpy(), n_ev.numpy(), *(x.numpy() for x in c))


def _zero_carry(b):
    return (np.zeros(b, np.float32), np.zeros(b, np.float32), np.zeros(b, np.int32))


def _stage_case(case):
    """(sig, slen, carry, e_cap, detector parameters, emissions or None,
    a chunk to run first for the carry or None) of a case."""
    rng = np.random.default_rng(STAGE_CASES.index(case))
    full = lambda b, l: np.full(b, l, np.int32)  # noqa: E731
    if case == "cell":  # the benchmark cell's chunk
        b, l = 256, 4000
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 768, STAGE, None, None
    if case == "w4096":
        b, l = 12, 4096
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 768, STAGE, None, None
    if case == "w28672":  # ava's chunk: both row programs in global memory
        b, l = 3, 28672
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 16384, STAGE, None, None
    if case == "carry":  # the second chunk of reads, on the first one's carry
        b, l = 6, 2000
        first = signal_chunk(rng, b, l), full(b, l)
        return signal_chunk(rng, b, l), full(b, l), None, 768, STAGE, None, first
    if case == "slen":  # rows of 0 samples, a few, all of L and past it
        b, l = 8, 3000
        slen = np.array([0, 0, 1, 17, 1500, l, l + 5, 2999], np.int32)
        return signal_chunk(rng, b, l), slen, _zero_carry(b), 768, STAGE, None, None
    if case == "clipped":  # a carry whose mean lies far from the chunk: every
        # sample of rows 0 and 2 clipped; row 1 carries nothing
        b, l = 3, 1000
        n = np.array([100000, 0, 50000], np.int32)
        mean = np.array([400.0, 0.0, -300.0])
        c_sum = (n * mean).astype(np.float32)
        c_sq = (n * (mean * mean + 1.0)).astype(np.float32)
        return signal_chunk(rng, b, l), full(b, l), (c_sum, c_sq, n), 768, STAGE, None, None
    if case == "over_e_cap":  # more peaks than e_cap on every row
        b, l = 5, 4000
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 40, STAGE, None, None
    if case == "short_segments":  # windows of 1 and 2: segments of 2 and 3
        b, l = 6, 2500
        levels = rng.normal(90, 25, (b, l // 2 + 1))
        sig = (np.repeat(levels, 2, 1)[:, :l] + rng.normal(0, 0.5, (b, l)))
        return (sig.astype(np.float16).astype(np.float32), full(b, l), _zero_carry(b),
                768, SHORT, None, None)
    if case == "crafted_peaks":  # emissions the detector does not give: the
        # same peak twice (a segment of 0), adjacent peaks (1), a segment of
        # more than 64 (sorted by the whole block), peaks at 0 and past n_sig
        # (not counted), on rows of 600 samples
        b, l = 4, 600
        em = np.full((b, 2 * l), -1, np.int32)
        for r in range(b):
            pos = np.sort(rng.choice(np.r_[1:200, 300:580], 150, replace=False))
            pos = np.concatenate([pos, pos[::7], [0, 0, 599, 700]])
            em[r, rng.choice(2 * l, pos.size, replace=False)] = pos
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 96, STAGE, em, None
    if case == "long_segment":  # ava-wide rows, whose segments of more than 64
        # values the kernel sorts through a tile of 8192: a segment longer
        # than the tile, one of exactly 8192, of 100, 65 and 64, short ones
        b, l = 2, 28672
        em = np.full((b, 2 * l), -1, np.int32)
        for r in range(b):
            pos = np.concatenate([np.arange(9, 3000, 7), [12000 + r, 20192 + r],
                                  np.arange(20200, 26000, 11), [26097, 26162, 26226]])
            em[r, rng.choice(2 * l, pos.size, replace=False)] = pos
        return signal_chunk(rng, b, l), full(b, l), _zero_carry(b), 16384, STAGE, em, None
    if case == "ties":  # integer samples: equal values inside segments
        b, l = 6, 3000
        levels = rng.integers(80, 100, (b, l // 9 + 1))
        sig = (np.repeat(levels, 9, 1)[:, :l] + rng.integers(-1, 2, (b, l)))
        return sig.astype(np.float32), full(b, l), _zero_carry(b), 768, STAGE, None, None
    raise KeyError(case)


STAGE_CASES = ["cell", "w4096", "w28672", "carry", "slen", "clipped", "over_e_cap",
               "short_segments", "crafted_peaks", "long_segment", "ties"]


@pytest.mark.parametrize("case", STAGE_CASES)
def test_events_stage_header_matches_plain(case, monkeypatch):
    """The events stage's kernels (events_fused.cuh's two row programs
    around the peak detector), built for the host, give detect_events_batch's
    events, counts and carry on CPU tensors bit for bit."""
    sig, slen, carry, e_cap, prm, emitted, first = _stage_case(case)
    b, l = sig.shape
    if first is not None:  # the carry both sides take from the first chunk
        got0 = host_stage(*first, _zero_carry(b), e_cap, prm)[0]
        want0 = plain_stage(*first, _zero_carry(b), e_cap, prm)
        for g, w in zip(got0, want0):
            np.testing.assert_array_equal(g, w)
        carry = want0[2:]
    got, em = host_stage(sig, slen, carry, e_cap, prm, emitted)
    want = plain_stage(sig, slen, carry, e_cap, prm, emitted, monkeypatch)
    for name, g, w in zip(("events", "n_ev", "sum", "sum_sq", "n"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=name)
    events, n_ev = want[:2]
    assert (events[:, :e_cap][np.arange(e_cap)[None, :] >= n_ev[:, None]] == 0).all()
    # what each case is there for
    wide = stage_plan(l, e_cap)[1]
    assert wide == ([True, True] if l == 28672 else [False, False])
    if case == "cell":
        assert n_ev.min() > 100
    elif case == "carry":
        assert (carry[2] == l).all() and (want[4] == 2 * l).all()
    elif case == "slen":
        assert (n_ev[:3] == 0).all() and n_ev[4:].min() > 50
    elif case == "clipped":
        assert (n_ev[[0, 2]] == 0).all() and n_ev[1] > 50
    elif case == "over_e_cap":
        assert (n_ev == e_cap).all()
    elif case in ("short_segments", "crafted_peaks"):
        lens = set()
        for r in range(b):
            pk = np.sort(em[r][(em[r] > 0) & (em[r] < l)])[: n_ev[r]]
            lens |= set(np.diff(np.concatenate([[0], pk])).tolist())
        assert {2, 3} <= lens and (case == "short_segments" or (
            {0, 1} <= lens and max(lens) > 64))
    elif case == "long_segment":
        gaps = np.diff(np.sort(em[0][em[0] > 0]))
        assert gaps.max() > 8192 and {8192, 100, 65, 64} <= set(gaps) and (n_ev > 500).all()
    elif case == "ties":
        assert n_ev.min() > 100
