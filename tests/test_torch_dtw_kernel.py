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


def host_dtw(a, a_len, b, b_len, radius, r):
    """rh_dtw_banded_host: every pair through rh_dtw_pair, as the kernel's
    threads run them."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    lib = load_host_library("dtw_banded")
    lib.rh_dtw_banded_host.argtypes = [P] * 6 + [ctypes.c_int] * 3
    lib.rh_dtw_banded_host.restype = ctypes.c_int
    out = np.full(a.shape[0], np.nan, np.float32)
    ptr = [x.ctypes.data_as(P) for x in (a, a_len, b, b_len, radius, out)]
    assert lib.rh_dtw_banded_host(*ptr, a.shape[0], a.shape[1], r) == 0
    return out


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
