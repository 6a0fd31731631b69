"""The banded DTW kernel's own logic on the CPU: csrc/dtw_banded.cuh (a pair's
columns, the band at row positions, the prefix sum in XLA's CPU order), built
for the host with g++ (csrc/dtw_banded_host.cpp), held bit for bit against
the plain PyTorch version (dtw/device.py::dtw_banded_batch_plain) at every
band width the host wrapper makes and at its edge cases; and the wrapper's
route and checks.  tests/test_torch_dtw.py holds the plain version against
the JAX package; the kernel itself runs on a card in test_torch_cuda.py."""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch._build import load_host_library  # noqa: E402
from rawhash_tpu_torch.dtw import device as tdtw  # noqa: E402

P = ctypes.c_void_p


def _host_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    lib = load_host_library("dtw_banded")
    lib.rh_dtw_banded_host.argtypes = [P] * 9 + [ctypes.c_int] * 5
    lib.rh_dtw_banded_host.restype = ctypes.c_int
    return lib


def host_ragged(values, a_off, a_len, b_off, b_len, radius, r, *, order,
                threshold=tdtw.WARP_COLUMNS, long_warps=None,
                cap=2 ** 31 - 1, b_values=None):
    """rh_dtw_banded_host: each position of the order on the warp path
    (the lanes as a loop) or a thread's, by the kernel's own rule."""
    lib = _host_lib()
    n = a_len.shape[0]
    out = np.full(n, np.nan, np.float32)
    b_values = values if b_values is None else b_values
    arrays = (values, a_off, a_len, b_values, b_off, b_len, radius)
    ptr = [x.ctypes.data_as(P) for x in arrays]
    ptr += [order.ctypes.data_as(P), out.ctypes.data_as(P)]
    assert lib.rh_dtw_banded_host(*ptr, n, r, cap, threshold,
                                  n if long_warps is None else long_warps) == 0
    return out


def host_dtw(a, a_len, b, b_len, radius, r, **kw):
    """The padded rows as the padded entry passes them: offsets p L, cap L,
    the pairs longest first."""
    n, max_len = a.shape
    off = (np.arange(n) * max_len).astype(np.int32)
    order = np.argsort(-np.minimum(a_len, max_len), kind="stable").astype(np.int32)
    kw.setdefault("order", order)
    return host_ragged(a.ravel(), off, a_len, off, b_len, radius, r, cap=max_len,
                       b_values=b.ravel(), **kw)


def plain(a, a_len, b, b_len, radius, r):
    return tdtw.dtw_banded_batch_plain(
        *(torch.from_numpy(x) for x in (a, a_len, b, b_len, radius)), max_radius=r).numpy()


def batch(rng, n, max_len, r, edges=True):
    """n padded pairs (the longer in a) of up to max_len events, per-pair
    radii 1..r; with edges, the cases where a kernel that computes DTW
    would not equal the plain version: the longest pair, pairs of length
    1, b no longer than the radius, a_len == b_len, and pairs that stop
    far before max_len."""
    a_len = rng.integers(1, max_len + 1, n).astype(np.int32)
    b_len = rng.integers(1, max_len + 1, n).astype(np.int32)
    a_len = np.maximum(a_len, b_len)
    radius = rng.integers(1, max(r, 1) + 1, n).astype(np.int32)
    if edges:
        a_len[0] = max_len
        a_len[1], b_len[1] = 1, 1
        a_len[2], b_len[2] = max_len, 1
        b_len[3] = max(1, min(radius[3], a_len[3]))
        b_len[4] = a_len[4]
        a_len[5], b_len[5] = 3, 2
        radius[6] = max(r, 1)
    a = np.zeros((n, max_len), np.float32)
    b = np.zeros((n, max_len), np.float32)
    for i in range(n):
        a[i, :a_len[i]] = rng.normal(0, 1, a_len[i])
        b[i, :b_len[i]] = rng.normal(0, 1, b_len[i])
    return a, a_len, b, b_len, radius


@pytest.mark.parametrize("r", [4, 8, 16, 32, 64, 128, 256, 512])
def test_dtw_header_matches_plain(r):
    """Widths 9, 17, 33, 65, 129, 257, 513 and 1025 (the host wrapper's
    powers of two; one to three levels of the prefix sum): every cost
    bit-equal, the edge cases among them."""
    rng = np.random.default_rng(r)
    max_len = max(40, 2 * r + 24) if r <= 64 else r + 40
    args = batch(rng, 24, max_len, r)
    want = plain(*args, r)
    got = host_dtw(*args, r)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).all() and (want > 0).sum() >= 20


@pytest.mark.parametrize("r", [0, 1, 5])
def test_dtw_header_at_any_radius(r):
    """A max_radius that is no power of two (widths 1, 3, 11): the band of
    one slot has no neighbour to read ahead."""
    rng = np.random.default_rng(100 + r)
    args = batch(rng, 16, 30, r)
    np.testing.assert_array_equal(host_dtw(*args, r), plain(*args, r))


def test_dtw_header_stops_each_pair_at_its_a_len():
    """Rows that stop far before max_len: the plain version freezes their
    band, the kernel stops stepping them; the costs agree, and agree with
    the same pairs padded no further than they need."""
    rng = np.random.default_rng(9)
    a, a_len, b, b_len, radius = batch(rng, 12, 200, 16, edges=False)
    a_len[1:] = rng.integers(3, 20, 11)
    b_len[1:] = np.minimum(b_len[1:], a_len[1:])
    a[1:, 20:] = 0.0
    b[1:, 20:] = 0.0
    got = host_dtw(a, a_len, b, b_len, radius, 16)
    np.testing.assert_array_equal(got, plain(a, a_len, b, b_len, radius, 16))
    short = tuple(x[1:] for x in (a, a_len, b, b_len, radius))
    np.testing.assert_array_equal(got[1:], plain(short[0][:, :40], short[1],
                                                 short[2][:, :40], *short[3:], 16))


def test_dtw_header_takes_csum_in_xlas_order():
    """Costs whose sums round differently in a sequential order: the band's
    prefix sum must add as XLA's CPU backend does (blocks of 16), or the
    costs move."""
    rng = np.random.default_rng(12)
    a, a_len, b, b_len, radius = batch(rng, 16, 120, 32)
    a *= np.float32(1000.0)
    b *= np.float32(0.001)
    want = plain(a, a_len, b, b_len, radius, 32)
    np.testing.assert_array_equal(host_dtw(a, a_len, b, b_len, radius, 32), want)


def test_dtw_banded_batch_on_cpu_tensors_is_plain():
    """On CPU tensors the wrapper returns the plain version's costs and
    counts no launch."""
    rng = np.random.default_rng(4)
    args = batch(rng, 10, 50, 8)
    before = tdtw.dtw_banded_batch.launches
    got = tdtw.dtw_banded_batch(*(torch.from_numpy(x) for x in args), max_radius=8)
    assert tdtw.dtw_banded_batch.launches == before
    np.testing.assert_array_equal(got.numpy(), plain(*args, 8))
    np.testing.assert_array_equal(got.numpy(), host_dtw(*args, 8))


def _bad_inputs():
    a = torch.zeros((4, 16))
    n = torch.ones(4, dtype=torch.int32)
    return {
        "f64 a": (a.double(), n, a, n, n),
        "i64 a_len": (a, n.long(), a, n, n),
        "i64 radius": (a, n, a, n, n.long()),
        "transposed b": (a, n, torch.zeros((16, 4)).t(), n, n),
        "narrower b": (a, n, a[:, :8].contiguous(), n, n),
        "short b_len": (a, n, a, n[:3], n),
        "1-D a": (a[0], n, a, n, n),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_dtw_banded_batch_rejects_wrong_dtype_or_layout(case):
    with pytest.raises(ValueError):
        tdtw.dtw_banded_batch(*_bad_inputs()[case], max_radius=4)


RADII = [0, 1, 5, 4, 8, 16, 32, 64, 128, 256, 512]  # widths 1, 3, 11, 9-1025


def _case(r, seed):
    rng = np.random.default_rng(seed)
    max_len = max(40, 2 * r + 24) if r <= 64 else r + 40
    return batch(rng, 24, max_len, r)


@pytest.mark.parametrize("path", ["warp", "thread"])
@pytest.mark.parametrize("r", RADII)
def test_dtw_header_each_path_matches_plain(path, r):
    """Every pair forced on the warp path (threshold 0: the lanes as a
    loop, where the band has fewer than 256 slots; wider bands have no warp
    path) or on the thread path (a threshold no pair reaches), the edge
    cases of batch() among them: every cost bit-equal to the plain
    version's."""
    args = _case(r, 200 + r)
    want = plain(*args, r)
    got = host_dtw(*args, r, threshold=0 if path == "warp" else 2 ** 30)
    np.testing.assert_array_equal(got, want)


# radii whose widths take every lag of the warp path (its least for the
# band, rh_dtw_default_lag): 2 up to 63 slots, then 3 (65), 4 (97), 5 (129),
# 6 (161), 7 (193) and 8 (255)
LAG_RADII = {0: 2, 4: 2, 5: 2, 8: 2, 16: 2, 32: 3, 48: 4, 64: 5, 80: 6, 96: 7, 127: 8}


@pytest.mark.parametrize("r", list(LAG_RADII))
def test_dtw_header_warp_path_at_every_lag(r):
    """The warp path at each lag a band width takes (each lane's columns
    32 lag steps apart, its neighbour's lag steps behind), every pair on
    it: bit-equal."""
    lib = _host_lib()
    lib.rh_dtw_warp_lag_host.argtypes = [ctypes.c_int]
    assert lib.rh_dtw_warp_lag_host(2 * r + 1) == LAG_RADII[r]
    args = _case(r, 300 + r)
    np.testing.assert_array_equal(host_dtw(*args, r, threshold=0), plain(*args, r))


def test_dtw_header_default_lag():
    """The warp path's lag: 2, or the least with width < 32 lag; none (the
    thread path) past 255 slots."""
    lib = _host_lib()
    lib.rh_dtw_warp_lag_host.argtypes = [ctypes.c_int]
    got = {w: lib.rh_dtw_warp_lag_host(w) for w in (1, 9, 33, 63, 65, 129, 255, 257, 1025)}
    assert got == {1: 2, 9: 2, 33: 2, 63: 2, 65: 3, 129: 5, 255: 8, 257: 0, 1025: 0}


def test_dtw_header_b_longer_than_a():
    """Pairs whose b is the longer (the host wrapper never makes them; the
    padded signature takes them): the band slides every column, which the
    closed-form center gives too; both paths equal the plain version."""
    rng = np.random.default_rng(31)
    a, a_len, b, b_len, radius = batch(rng, 20, 60, 16, edges=False)
    b_len[:10] = np.minimum(a_len[:10] + rng.integers(1, 20, 10), 60).astype(np.int32)
    b[:10] = rng.normal(0, 1, (10, 60)).astype(np.float32)
    for i in range(10):
        b[i, b_len[i]:] = 0.0
    want = plain(a, a_len, b, b_len, radius, 16)
    for threshold in (0, 2 ** 30):
        got = host_dtw(a, a_len, b, b_len, radius, 16, threshold=threshold)
        np.testing.assert_array_equal(got, want)


def test_dtw_closed_form_center_equals_the_stepped_rule():
    """Column i's center, floor(i b_len / a_len) (i past b_len > a_len),
    equals the plain version's step from center 0 at every column of every
    pair of lengths up to 64, and on long pairs."""
    lib = _host_lib()
    lib.rh_dtw_centers_host.argtypes = [ctypes.c_int] * 3 + [P, P]
    cases = [(x, y) for x in range(1, 65) for y in range(0, 70)]
    cases += [(5000, 4999), (4999, 17), (100000, 99991), (180, 1), (512, 511)]
    for a_len, b_len in cases:
        closed = np.zeros(a_len, np.int32)
        stepped = np.zeros(a_len, np.int32)
        lib.rh_dtw_centers_host(a_len, b_len, a_len, closed.ctypes.data_as(P),
                                stepped.ctypes.data_as(P))
        np.testing.assert_array_equal(closed, stepped, err_msg=f"{a_len} {b_len}")
        if b_len <= a_len:
            i = np.arange(a_len, dtype=np.int64)
            np.testing.assert_array_equal(closed, i * b_len // a_len)


def _pairs(rng, n, longest, r_frac=0.1):
    """n pairs as the chain evaluation makes them: mostly a few events,
    some of up to `longest`, either sequence the longer, float32."""
    lens = np.where(rng.random(n) < 0.9, rng.integers(1, 8, n), rng.integers(8, longest + 1, n))
    lens[0] = longest
    pairs = []
    for n_x in lens:
        n_y = max(1, int(n_x) + int(rng.integers(-6, 3)))
        x = rng.normal(0, 1, int(n_x)).astype(np.float32)
        y = rng.normal(0, 1, n_y).astype(np.float32)
        pairs.append((x, y) if rng.random() < 0.5 else (y, x))
    radii = [max(1, int(max(len(x), len(y)) * r_frac)) for x, y in pairs]
    return pairs, radii


def _padded(pairs):
    """The pairs swapped and padded as the host wrapper did before it packed
    them ragged: a Python loop over the pairs."""
    sw = [(x, y) if x.shape[0] >= y.shape[0] else (y, x) for x, y in pairs]
    max_len = max(x.shape[0] for x, _ in sw)
    a = np.zeros((len(sw), max_len), np.float32)
    b = np.zeros((len(sw), max_len), np.float32)
    for i, (x, y) in enumerate(sw):
        a[i, :x.shape[0]] = x
        b[i, :y.shape[0]] = y
    return (a, np.array([x.shape[0] for x, _ in sw], np.int32), b,
            np.array([y.shape[0] for _, y in sw], np.int32))


def test_pack_pairs_rebuilds_the_padded_arrays():
    """pack_pairs (vectorised numpy): the longer sequence as a, the order
    longest first and stable, the long pairs' count; padded back to the
    longest (as the CPU route pads them), the arrays the per-pair loop made,
    exactly."""
    rng = np.random.default_rng(41)
    pairs, radii = _pairs(rng, 300, 90)
    pairs.append((rng.normal(0, 1, 5), rng.normal(0, 1, 5)))  # float64, equal lengths
    radii.append(2)
    values, a_off, a_len, b_off, b_len, radius, order, n_long = tdtw.pack_pairs(pairs, radii)
    a, a_len0, b, b_len0 = _padded([(np.asarray(x, np.float32), np.asarray(y, np.float32))
                                    for x, y in pairs])
    assert values.dtype == np.float32 and values.shape[0] == a_len.sum() + b_len.sum()
    np.testing.assert_array_equal(a_len, a_len0)
    np.testing.assert_array_equal(b_len, b_len0)
    np.testing.assert_array_equal(radius, np.asarray(radii, np.int32))
    np.testing.assert_array_equal(order, np.argsort(-a_len, kind="stable"))
    assert list(a_len[order]) == sorted(a_len, reverse=True)
    assert n_long == (a_len >= tdtw.WARP_COLUMNS).sum() > 0
    assert (a_len[order[:n_long]] >= tdtw.WARP_COLUMNS).all()
    width = a.shape[1]
    v = torch.from_numpy(values)
    pad = tdtw._pad_rows
    np.testing.assert_array_equal(pad(v, torch.from_numpy(a_off), torch.from_numpy(a_len),
                                      width).numpy(), a)
    np.testing.assert_array_equal(pad(v, torch.from_numpy(b_off), torch.from_numpy(b_len),
                                      width).numpy(), b)


@pytest.mark.parametrize("path", ["warp", "thread", "default"])
def test_dtw_ragged_layout_matches_padded(path):
    """The ragged rows (each pair's own b_len, most far shorter than the
    longest; b read no further than its own row) through the header, the
    pairs given in a shuffled order and in the packed one: the costs of
    the padded plain version, bit for bit."""
    rng = np.random.default_rng(43)
    pairs, radii = _pairs(rng, 200, 120)
    values, a_off, a_len, b_off, b_len, radius, order, n_long = tdtw.pack_pairs(pairs, radii)
    r = tdtw._pow2_at_least(int(radius.max()), 4)
    a, a_len0, b, b_len0 = _padded(pairs)
    want = plain(a, a_len0, b, b_len0, radius, r)
    assert (b_len < a.shape[1]).sum() > 150
    kw = {"warp": dict(threshold=0), "thread": dict(threshold=2 ** 30),
          "default": dict(long_warps=n_long)}[path]
    for ordering in (order, rng.permutation(len(pairs)).astype(np.int32)):
        got = host_ragged(values, a_off, a_len, b_off, b_len, radius, r, order=ordering, **kw)
        np.testing.assert_array_equal(got, want)


def test_dtw_ragged_on_cpu_tensors_is_plain():
    """dtw_banded_ragged on CPU tensors: the plain version on the pairs
    padded to the longest, no launch counted; dtw_banded_batch_host on the
    CPU returns the same."""
    rng = np.random.default_rng(47)
    pairs, radii = _pairs(rng, 60, 40)
    packed = tdtw.pack_pairs(pairs, radii)
    r = tdtw._pow2_at_least(int(packed[5].max()), 4)
    before = tdtw.dtw_banded_batch.launches
    got = tdtw.dtw_banded_ragged(*(torch.from_numpy(x) for x in packed[:7]), max_radius=r)
    assert tdtw.dtw_banded_batch.launches == before
    a, a_len, b, b_len = _padded(pairs)
    want = plain(a, a_len, b, b_len, packed[5], r)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdtw.dtw_banded_batch_host(pairs, radii, device="cpu"), want)


def _bad_ragged():
    v = torch.zeros(32)
    n = torch.ones(4, dtype=torch.int32)
    return {
        "f64 values": (v.double(), n, n, n, n, n, n),
        "2-D values": (v.view(4, 8), n, n, n, n, n, n),
        "i64 a_off": (v, n.long(), n, n, n, n, n),
        "short order": (v, n, n, n, n, n, n[:3]),
        "i64 radius": (v, n, n, n, n, n.long(), n),
    }


@pytest.mark.parametrize("case", list(_bad_ragged()))
def test_dtw_banded_ragged_rejects_wrong_dtype_or_layout(case):
    with pytest.raises(ValueError):
        tdtw.dtw_banded_ragged(*_bad_ragged()[case], max_radius=4)


def _broken_ragged():
    """Ragged inputs whose dtypes and shapes are right but whose promises
    (order a permutation, every row inside values) are broken."""
    v = torch.zeros(32)
    off = torch.tensor([0, 8, 16, 24], dtype=torch.int32)
    n = torch.full((4,), 4, dtype=torch.int32)
    order = torch.arange(4, dtype=torch.int32)
    return {
        "repeated pair in order": (v, off, n, off, n, n, torch.tensor([0, 1, 1, 3],
                                                                       dtype=torch.int32)),
        "order out of range": (v, off, n, off, n, n, order + 1),
        "a past values": (v, off + 5, n, off, n, n, order),
        "b before values": (v, off, n, off - 1, n, n, order),
    }


@pytest.mark.parametrize("case", list(_broken_ragged()))
def test_dtw_banded_ragged_checks_order_and_rows_on_cpu(case):
    """The CPU route checks what the card route trusts: a repeated or
    missing pair in `order`, a row outside `values`."""
    with pytest.raises(ValueError):
        tdtw.dtw_banded_ragged(*_broken_ragged()[case], max_radius=4)
    good = _broken_ragged()["a past values"]
    fixed = (good[0], good[1] - 5, *good[2:])
    assert tdtw.dtw_banded_ragged(*fixed, max_radius=4).shape == (4,)
