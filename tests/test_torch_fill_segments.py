"""K1's segment fill: the pieces of csrc/chain_fill.cuh that the CUDA kernel
runs (rh_segment_start, rh_fill_segment), built with g++, filling each row
segment by segment in reverse and in a shuffled order, bit for bit against
the port's plain fill, the JAX fill and the Pallas kernel in interpret mode;
and the segment counts of profiling/bounds.py against a numpy count.  The
kernel itself runs on a card (test_torch_cuda.py, chip_smoke.py)."""

import ctypes
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu.chain.device import chain_fill_batch as jax_fill  # noqa: E402
from rawhash_tpu.chain.pallas_fill import chain_fill_pallas  # noqa: E402
from rawhash_tpu_torch._build import CSRC  # noqa: E402
from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.chain.fill import MAX_ITER_CAP  # noqa: E402
from rawhash_tpu_torch.cli import main as cli_main  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.profiling.bounds import fill_segments, fill_work  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    border_anchors, options, sparse_anchors, wide_band_anchors,
)

# the chaining parameters of the viral and sensitive presets, without W
PRESETS = {
    name: {k: v for k, v in fill_params(*options(name)).items() if k != "max_iter"}
    for name in ("viral", "sensitive")
}


def anchors(seed, b, n, clustered):
    """Sorted anchors from a numpy seed, as test_torch_chain.py makes them:
    uniform, or clustered along diagonals so long chains form."""
    rng = np.random.default_rng(seed)
    if clustered:
        tpos = np.sort(rng.integers(0, 4 * n, (b, n)), axis=1).astype(np.int32)
        qpos = (tpos // 2 + rng.integers(-20, 20, (b, n))).clip(0).astype(np.int32)
        key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
    else:
        key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
        tpos = np.sort(rng.integers(0, 5000, (b, n)), axis=1).astype(np.int32)
        qpos = rng.integers(0, 700, (b, n)).astype(np.int32)
    n_anchors = rng.integers(n // 4, n + 1, b).astype(np.int32)
    n_anchors[0] = n
    return key, tpos, qpos, n_anchors


def edge_anchors(preset):
    """Rows at the segment borders (synthetic.border_anchors) at a preset's
    max_dist_t."""
    prm = PRESETS[preset]
    a = border_anchors(prm["max_dist_t"], prm["bw"])
    gaps = np.diff(a[1][0])
    mdt = max(prm["max_dist_t"], prm["bw"])
    assert (gaps == mdt).any() and (gaps == mdt + 1).any() and (gaps == 0).any()
    return a


HARNESS = r"""
#include "chain_fill.cuh"
static RhParams params(int q_span, int mdt, int mdq, int bw, int w, float pg,
                       float ps) {
  RhParams P = {q_span, mdt, mdq, bw, w, pg, ps};
  return P;
}
extern "C" int segment_starts(const int* key, const int* tpos, int n_a,
    int q_span, int mdt, int mdq, int bw, int w, float pg, float ps,
    int* starts) {
  RhParams P = params(q_span, mdt, mdq, bw, w, pg, ps);
  int c = 0;
  for (int i = 0; i < n_a; ++i)
    if (rh_segment_start(i, i > 0 ? key[i - 1] : 0, i > 0 ? tpos[i - 1] : 0,
                         key[i], tpos[i], P))
      starts[c++] = i;
  return c;
}
extern "C" void fill_segment(const int* key, const int* tpos, const int* qpos,
    int s, int e, int q_span, int mdt, int mdq, int bw, int w, float pg,
    float ps, int* f, int* p, int* ring) {
  rh_fill_segment(key, tpos, qpos, s, e, f, p, ring,
                  params(q_span, mdt, mdq, bw, w, pg, ps));
}
extern "C" int fill_warps(int w, int max_warps) {
  return rh_fill_warps(w, max_warps);
}
extern "C" void fill_share(const int* key, const int* tpos, const int* qpos,
    int n_a, int warp, int warps, int q_span, int mdt, int mdq, int bw, int w,
    float pg, float ps, int* f, int* p, int* ring) {
  rh_fill_share(key, tpos, qpos, n_a, warp, warps, f, p, ring,
                params(q_span, mdt, mdq, bw, w, pg, ps));
}
extern "C" long long ring_offset(int row, int warp, int warps, int w) {
  return rh_ring_offset(row, warp, warps, w);
}
extern "C" int global_warps(int w, int max_warps, long long budget) {
  return rh_fill_global_warps(w, max_warps, budget);
}
extern "C" int global_rows(int b, int w, int warps, long long budget) {
  return rh_fill_global_rows(b, w, warps, budget);
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """chain_fill.cuh built as host C++ with separately rounded float ops,
    as nvcc --fmad=false builds it for the card."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    d = tmp_path_factory.mktemp("segments")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.segment_starts.restype = i
    lib.segment_starts.argtypes = [ptr] * 2 + [i] * 6 + [fl] * 2 + [ptr]
    lib.fill_segment.argtypes = [ptr] * 3 + [i] * 7 + [fl] * 2 + [ptr] * 3
    lib.fill_warps.restype = i
    lib.fill_warps.argtypes = [i, i]
    lib.fill_share.argtypes = [ptr] * 3 + [i] * 8 + [fl] * 2 + [ptr] * 3
    ll = ctypes.c_longlong
    lib.ring_offset.restype = ll
    lib.ring_offset.argtypes = [i] * 4
    lib.global_warps.restype = i
    lib.global_warps.argtypes = [i, i, ll]
    lib.global_rows.restype = i
    lib.global_rows.argtypes = [i, i, i, ll]
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def segment_fill(lib, key, tpos, qpos, n_anchors, prm, w, order, seed=0):
    """f, p filled one segment at a time through rh_fill_segment, the
    segments of each row visited in `order` ("reverse" or "shuffled"), with
    one ring of random garbage reused by every segment; and the number of
    segments."""
    rng = np.random.default_rng(seed)
    key = np.ascontiguousarray(key).view(np.int32)
    b, n = key.shape
    c = (prm["q_span"], max(prm["max_dist_t"], prm["bw"]),
         max(prm["max_dist_q"], prm["bw"]), prm["bw"], w, prm["chn_pen_gap"],
         prm["chn_pen_skip"])
    f = np.full((b, n), 12345, np.int32)
    p = np.full((b, n), 12345, np.int32)
    ring = rng.integers(-2**31, 2**31, 4 * w).astype(np.int32)
    n_seg = 0
    for r in range(b):
        n_a = min(max(int(n_anchors[r]), 0), n)
        starts = np.zeros(max(n_a, 1), np.int32)
        cnt = lib.segment_starts(_p(key[r]), _p(tpos[r]), n_a, *c, _p(starts))
        segs = list(zip(starts[:cnt].tolist(), starts[1:cnt].tolist() + [n_a]))
        segs = segs[::-1] if order == "reverse" else [segs[k] for k in rng.permutation(cnt)]
        for s, e in segs:
            lib.fill_segment(_p(key[r]), _p(tpos[r]), _p(qpos[r]), s, e, *c,
                             _p(f[r]), _p(p[r]), _p(ring))
        f[r, n_a:] = 0
        p[r, n_a:] = -1
        n_seg += cnt
    return f, p, n_seg


INPUTS = {
    "uniform": lambda: anchors(23, 4, 500, False),
    "clustered": lambda: anchors(29, 4, 500, True),
    "sparse": lambda: sparse_anchors(31, 5, 600),
}


@functools.cache
def references(name, preset, w):
    """The port's plain fill and the JAX fill on one input, as numpy."""
    a = INPUTS[name]()
    args = dict(PRESETS[preset], max_iter=w)
    f_j, p_j = jax_fill(*(jnp.asarray(x) for x in a), **args)
    f_t, p_t = chain_fill_batch(*_torch(*a), **args)
    return a, (f_t.numpy(), p_t.numpy()), (np.asarray(f_j), np.asarray(p_j))


def _torch(key, tpos, qpos, n_anchors):
    return (torch.from_numpy(np.ascontiguousarray(key).view(np.int32)),
            torch.from_numpy(tpos), torch.from_numpy(qpos),
            torch.from_numpy(n_anchors))


def _sorted_and_counted(a, prm, w, n_seg):
    """The input is sorted as the segment fill needs (no in-band pair past
    an out-of-band one), and the harness split it as fill_segments does."""
    t = _torch(*a)
    assert fill_work(*t, **prm, max_iter=w)["unsorted"] == 0
    assert fill_segments(t[0], t[1], t[3], **prm)["segments"] == n_seg


@pytest.mark.parametrize("order", ["reverse", "shuffled"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_segment_fill_matches_plain_and_jax(harness, name, preset, order):
    w = 200
    a, (f_t, p_t), (f_j, p_j) = references(name, preset, w)
    prm = PRESETS[preset]
    f, p, n_seg = segment_fill(harness, *a, prm, w, order, seed=len(name))
    _sorted_and_counted(a, prm, w, n_seg)
    np.testing.assert_array_equal(f, f_t)
    np.testing.assert_array_equal(p, p_t)
    np.testing.assert_array_equal(f, f_j)
    np.testing.assert_array_equal(p, p_j)


@pytest.mark.parametrize("w", [1, 16, 200])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_segment_fill_at_the_borders(harness, preset, w):
    a = edge_anchors(preset)
    prm = PRESETS[preset]
    args = dict(prm, max_iter=w)
    f_t, p_t = chain_fill_batch(*_torch(*a), **args)
    f_j, p_j = jax_fill(*(jnp.asarray(x) for x in a), **args)
    for order in ("reverse", "shuffled"):
        f, p, n_seg = segment_fill(harness, *a, prm, w, order, seed=w)
        np.testing.assert_array_equal(f, f_t.numpy())
        np.testing.assert_array_equal(p, p_t.numpy())
        np.testing.assert_array_equal(f, np.asarray(f_j))
        np.testing.assert_array_equal(p, np.asarray(p_j))
    _sorted_and_counted(a, prm, w, n_seg)
    # rows 1 and 2 hold no anchor and one; row 3's last live anchor is alone
    assert (f[1] == 0).all() and (p[1] == -1).all()
    assert f[2, 0] == prm["q_span"] and p[2, 0] == -1 and (f[2, 1:] == 0).all()
    assert f[3, len(f[3]) - 8] == prm["q_span"] and p[3, len(p[3]) - 8] == -1
    assert (p[0] >= 0).sum() > 10  # chains formed across the borders


def test_segment_fill_matches_pallas_interpret(harness):
    a = sparse_anchors(37, 3, 260)
    prm = PRESETS["sensitive"]
    f_j, p_j = chain_fill_pallas(*(jnp.asarray(x) for x in a), **prm,
                                 max_iter=64, interpret=True)
    f, p, n_seg = segment_fill(harness, *a, prm, 64, "shuffled", seed=3)
    _sorted_and_counted(a, prm, 64, n_seg)
    np.testing.assert_array_equal(f, np.asarray(f_j))
    np.testing.assert_array_equal(p, np.asarray(p_j))


def _count_segments(key, tpos, n_anchors, max_dist_t, bw, **_):
    """Segment lengths counted anchor by anchor."""
    mdt = max(max_dist_t, bw)
    key = np.ascontiguousarray(key).view(np.int32).astype(np.int64)
    lengths = []
    for r in range(key.shape[0]):
        for i in range(min(int(n_anchors[r]), key.shape[1])):
            dr = int(tpos[r, i]) - int(tpos[r, i - 1]) if i else -1
            if i == 0 or key[r, i] != key[r, i - 1] or not 0 <= dr <= mdt:
                lengths.append(0)
            lengths[-1] += 1
    lengths = np.array(lengths, np.int64)
    return {"segments": len(lengths),
            "longest": int(lengths.max()) if len(lengths) else 0,
            "singletons": int((lengths == 1).sum()),
            "stepped": int(lengths.sum()) - len(lengths)}


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("name", [*sorted(INPUTS), "edges", "empty"])
def test_fill_segments_matches_a_numpy_count(name, preset):
    if name == "edges":
        a = edge_anchors(preset)
    elif name == "empty":
        a = tuple(np.zeros((2, 0), np.int32) for _ in range(3)) + (
            np.zeros(2, np.int32),)
    else:
        a = INPUTS[name]()
    prm = PRESETS[preset]
    got = fill_segments(*(_torch(*a)[i] for i in (0, 1, 3)), **prm)
    want = _count_segments(a[0], a[1], a[3], **prm)
    assert got == want
    if name == "sparse":  # mostly lone hits, and a few clusters stepped
        assert got["singletons"] > got["segments"] // 2
        assert got["stepped"] > 0 and got["longest"] >= 8


def test_ring_cap_follows_the_kernels_shared_memory(harness):
    """MAX_ITER_CAP is the largest W at which one warp's ring (W +
    RH_FILL_AHEAD slots of 16 bytes) fits a block's RH_FILL_SMEM bytes, as
    chain_fill.cuh lays the rings out; the presets' W fit 16 warps."""
    src = (CSRC / "chain_fill.cuh").read_text()
    ahead = int(re.search(r"#define RH_FILL_AHEAD (\d+)", src).group(1))
    smem = int(re.search(r"#define RH_FILL_SMEM (\d+)", src).group(1))
    assert MAX_ITER_CAP == smem // 16 - ahead
    assert harness.fill_warps(MAX_ITER_CAP, 16) == 1
    assert harness.fill_warps(MAX_ITER_CAP + 1, 16) == 0
    for preset in PRESETS:
        assert harness.fill_warps(fill_params(*options(preset))["max_iter"], 16) == 16


@pytest.mark.parametrize("w", [1, 200, 844, 845, 3600, MAX_ITER_CAP, MAX_ITER_CAP + 1])
def test_fill_warps_fit_the_blocks_shared_memory(harness, w):
    """A block runs as many warps a read as their rings fit in 227 KB, at
    most the number asked for: 16 up to W = 844, fewer past it, one at the
    cap, none past it."""
    warps = harness.fill_warps(w, 16)
    assert 0 <= warps <= 16
    assert 16 * warps * (w + 64) <= 232448
    assert warps == 16 or 16 * (warps + 1) * (w + 64) > 232448
    assert (warps >= 1) == (w <= MAX_ITER_CAP)
    assert harness.fill_warps(w, 4) == min(warps, 4)
    assert harness.fill_warps(w, 0) == 0


@pytest.mark.parametrize("w", [0])
def test_cli_refuses_max_iterations_the_card_cannot_fill(capsys, w):
    """On --device cuda the CLI refuses a W below 1, before it touches the
    card or the files."""
    rc = cli_main(["-x", "sensitive", "--max-iterations", str(w), "--device",
                   "cuda", "missing.rhi.npz", "missing.sig.npz"])
    assert rc != 0
    assert "--max-iterations must be at least 1" in capsys.readouterr().err


@pytest.mark.parametrize("w", [MAX_ITER_CAP + 1, 20000])
def test_cli_takes_max_iterations_past_the_shared_memory_cap(capsys, w):
    """A W past the shared-memory cap is taken on --device cuda (the fill's
    global-ring path): the run gets past the options and fails only for
    want of a card or of the missing files."""
    rc = cli_main(["-x", "sensitive", "--max-iterations", str(w), "--device",
                   "cuda", "missing.rhi.npz", "missing.sig.npz"])
    assert rc != 0
    assert "--max-iterations" not in capsys.readouterr().err


def share_fill(lib, key, tpos, qpos, n_anchors, prm, w, warps, rows, seed):
    """f, p filled warp share by warp share through rh_fill_share, in a
    shuffled order, each warp's ring at its rh_ring_offset in one scratch
    buffer of random garbage laid out as the kernel's global-ring path
    lays it out (`rows` rows a launch)."""
    rng = np.random.default_rng(seed)
    key = np.ascontiguousarray(key).view(np.int32)
    b, n = key.shape
    c = (prm["q_span"], max(prm["max_dist_t"], prm["bw"]),
         max(prm["max_dist_q"], prm["bw"]), prm["bw"], w, prm["chn_pen_gap"],
         prm["chn_pen_skip"])
    ints = lib.ring_offset(0, 1, warps, w)
    assert ints == 4 * (w + 64)
    assert lib.ring_offset(rows - 1, warps - 1, warps, w) + ints == rows * warps * ints
    scratch = rng.integers(-2**31, 2**31, rows * warps * ints).astype(np.int32)
    f = np.full((b, n), 12345, np.int32)
    p = np.full((b, n), 12345, np.int32)
    for r, warp in [(r, k) for r in range(b) for k in rng.permutation(warps)]:
        ring = scratch[lib.ring_offset(r % rows, int(warp), warps, w):]
        n_a = min(max(int(n_anchors[r]), 0), n)
        lib.fill_share(_p(key[r]), _p(tpos[r]), _p(qpos[r]), n_a, int(warp),
                       warps, *c, _p(f[r]), _p(p[r]), _p(ring))
    for r in range(b):
        n_a = min(max(int(n_anchors[r]), 0), n)
        f[r, n_a:] = 0
        p[r, n_a:] = -1
    return f, p


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("w,inputs", [
    (MAX_ITER_CAP + 1, "sparse"), (MAX_ITER_CAP + 1, "dense"),
    ("row", "dense"), ("3row", "dense")])
def test_global_ring_fill_matches_plain(harness, preset, w, inputs):
    """The kernel's global-ring path past the shared-memory cap, as g++
    builds its ring layout and warp shares from chain_fill.cuh: 16 warps a
    read (and 3, shares that split segments), two rows a launch, rings in
    one scratch buffer, bit for bit against the plain fill at W =
    MAX_ITER_CAP + 1 and at a W as long as the row or three times it, on
    rows whose every predecessor is in band and whose chains step 300
    anchors back (there W decides the result: it differs from W = 200's)."""
    prm = PRESETS[preset]
    a = (sparse_anchors(41, 3, 600) if inputs == "sparse"
         else wide_band_anchors(43, 3, 1200, prm["max_dist_q"], 300))
    w = {"row": a[0].shape[1], "3row": 3 * a[0].shape[1]}.get(w, w)
    f_t, p_t = chain_fill_batch(*_torch(*a), **prm, max_iter=w)
    for warps, seed in ((16, 1), (3, 2)):
        f, p = share_fill(harness, *a, prm, w, warps, rows=2, seed=seed)
        np.testing.assert_array_equal(f, f_t.numpy())
        np.testing.assert_array_equal(p, p_t.numpy())
    if inputs == "dense":
        f_200, _ = chain_fill_batch(*_torch(*a), **prm, max_iter=200)
        assert (f_t > f_200).any()


@pytest.mark.parametrize("w", [MAX_ITER_CAP + 1, 20000, 32704, 10**6])
def test_global_ring_plan_fits_its_budget(harness, w):
    """The global-ring path runs 16 warps a read and the whole batch in one
    launch while the scratch fits its budget (at 2 GiB, W = 20000 takes
    1.3 GB for 256 rows); past it, fewer rows a launch, then fewer warps,
    never less than one of each."""
    ring = 16 * (w + 64)
    budget = 2 << 30
    warps = harness.global_warps(w, 16, budget)
    rows = harness.global_rows(256, w, warps, budget)
    assert 1 <= warps <= 16 and 1 <= rows <= 256
    assert rows * warps * ring <= budget or (rows == 1 and warps == 1)
    assert warps == 16 or (warps + 1) * ring > budget
    assert rows == 256 or (rows + 1) * warps * ring > budget
    if w <= 32704:
        assert (warps, rows) == (16, 256)
    assert harness.global_warps(w, 16, ring - 1) == 1
    assert harness.global_rows(256, w, 16, 0) == 1
