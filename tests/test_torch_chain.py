"""The chaining DP fill: the plain PyTorch fill and the CUDA kernel's own
per-slot score and per-anchor step (csrc/chain_fill.cuh, built here with
g++) against the JAX reference, bit for bit.  The kernel itself runs on a
card in test_torch_cuda.py."""

import ctypes
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
from rawhash_tpu_torch.chain.device import _window_scores, chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.chain.fill import chain_fill  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.synthetic import options  # noqa: E402

# the chaining parameters of the viral and sensitive presets, without W
PRESETS = {
    name: {k: v for k, v in fill_params(*options(name)).items() if k != "max_iter"}
    for name in ("viral", "sensitive")
}


def anchors(seed, b, n, clustered):
    """Sorted anchors from a numpy seed: uniform, or clustered along
    diagonals so long chains form."""
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


def _torch_args(key, tpos, qpos, n_anchors):
    return (torch.from_numpy(key.view(np.int32)), torch.from_numpy(tpos),
            torch.from_numpy(qpos), torch.from_numpy(n_anchors))


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("seed,b,n,max_iter,clustered",
                         [(3, 6, 300, 64, False), (7, 4, 420, 200, True)])
def test_plain_fill_matches_jax(preset, seed, b, n, max_iter, clustered):
    a = anchors(seed, b, n, clustered)
    args = dict(PRESETS[preset], max_iter=max_iter)
    f_j, p_j = jax_fill(*(jnp.asarray(x) for x in a), **args)
    f_t, p_t = chain_fill_batch(*_torch_args(*a), **args)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_plain_fill_matches_pallas_interpret():
    a = anchors(11, 3, 260, True)
    args = dict(PRESETS["sensitive"], max_iter=64)
    f_j, p_j = chain_fill_pallas(*(jnp.asarray(x) for x in a), **args,
                                 interpret=True)
    f_t, p_t = chain_fill(*_torch_args(*a), **args)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_cpu_dispatch_is_plain_and_not_counted():
    a = _torch_args(*anchors(2, 2, 50, True))
    before = chain_fill.launches
    f, p = chain_fill(*a, **PRESETS["viral"], max_iter=16)
    f0, p0 = chain_fill_batch(*a, **PRESETS["viral"], max_iter=16)
    assert torch.equal(f, f0) and torch.equal(p, p0)
    assert chain_fill.launches == before


HARNESS = r"""
#include <vector>
#include "chain_fill.cuh"
extern "C" void window_scores(const int* k_i, const int* t_i, const int* q_i,
    const int* rk, const int* rt, const int* rq, const int* rf,
    const unsigned char* jv, int b, int w, int q_span, int mdt, int mdq, int bw,
    float pg, float ps, int* total, int* in_band) {
  RhParams P = {q_span, mdt, mdq, bw, w, pg, ps};
  for (int r = 0; r < b; ++r)
    for (int s = 0; s < w; ++s) {
      int o = r * w + s;
      RhSlot x = rh_slot(k_i[r], t_i[r], q_i[r], rk[o], rt[o], rq[o], rf[o], jv[o], P);
      total[o] = x.total;
      in_band[o] = x.in_band;
    }
}
extern "C" void fill_batch(const int* key, const int* tpos, const int* qpos,
    const int* n_anchors, int b, int n, int w, int q_span, int mdt, int mdq,
    int bw, float pg, float ps, int* f, int* p) {
  RhParams P = {q_span, mdt, mdq, bw, w, pg, ps};
  std::vector<int> ring(4 * (size_t)w);
  for (int r = 0; r < b; ++r)
    rh_fill_read(key + (size_t)r * n, tpos + (size_t)r * n, qpos + (size_t)r * n,
                 n_anchors[r], n, f + (size_t)r * n, p + (size_t)r * n, ring.data(), P);
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The kernel's header built as host C++ with separately rounded float
    ops, as nvcc --fmad=false builds it for the card."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    d = tmp_path_factory.mktemp("harness")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window_scores.argtypes = [ptr] * 8 + [i] * 6 + [fl] * 2 + [ptr] * 2
    lib.fill_batch.argtypes = [ptr] * 4 + [i] * 7 + [fl] * 2 + [ptr] * 2
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_kernel_slot_score_matches_plain(harness, preset):
    prm = PRESETS[preset]
    rng = np.random.default_rng(17)
    b, w = 64, 200
    k_i = rng.integers(0, 3, b).astype(np.int32)
    t_i = rng.integers(3000, 6000, b).astype(np.int32)
    q_i = rng.integers(1500, 3000, b).astype(np.int32)
    rk = rng.integers(0, 3, (b, w)).astype(np.int32)
    rt = (t_i[:, None] - rng.integers(-50, 2 * prm["max_dist_t"], (b, w))).astype(np.int32)
    rq = (q_i[:, None] - rng.integers(-50, 2 * prm["max_dist_q"], (b, w))).astype(np.int32)
    rf = rng.integers(prm["q_span"], 500, (b, w)).astype(np.int32)
    jv = rng.random((b, w)) < 0.9
    tot_c = np.zeros((b, w), np.int32)
    ib_c = np.zeros((b, w), np.int32)
    harness.window_scores(
        _p(k_i), _p(t_i), _p(q_i), _p(rk), _p(rt), _p(rq), _p(rf),
        _p(jv.astype(np.uint8)), b, w, prm["q_span"], prm["max_dist_t"],
        prm["max_dist_q"], prm["bw"], prm["chn_pen_gap"], prm["chn_pen_skip"],
        _p(tot_c), _p(ib_c),
    )
    t = torch.from_numpy
    sc, ok, ib = _window_scores(
        t(k_i), t(t_i), t(q_i), t(rk), t(rt), t(rq), t(jv),
        prm["q_span"], prm["max_dist_t"], prm["max_dist_q"], prm["bw"],
        prm["chn_pen_gap"], prm["chn_pen_skip"],
    )
    tot = torch.where(ok, sc + t(rf), -(2**31))
    assert (tot.numpy() > -(2**31)).sum() > b  # many allowed predecessors
    np.testing.assert_array_equal(tot_c, tot.numpy())
    np.testing.assert_array_equal(ib_c.astype(bool), ib.numpy())


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("clustered", [False, True])
def test_kernel_step_matches_plain(harness, preset, clustered):
    key, tpos, qpos, n_anchors = anchors(23, 5, 700, clustered)
    prm = PRESETS[preset]
    b, n, w = key.shape[0], key.shape[1], 200
    f_c = np.zeros((b, n), np.int32)
    p_c = np.zeros((b, n), np.int32)
    harness.fill_batch(
        _p(key), _p(tpos), _p(qpos), _p(n_anchors), b, n, w, prm["q_span"],
        max(prm["max_dist_t"], prm["bw"]), max(prm["max_dist_q"], prm["bw"]),
        prm["bw"], prm["chn_pen_gap"], prm["chn_pen_skip"], _p(f_c), _p(p_c),
    )
    f_t, p_t = chain_fill_batch(*_torch_args(key, tpos, qpos, n_anchors),
                                **prm, max_iter=w)
    np.testing.assert_array_equal(f_c, f_t.numpy())
    np.testing.assert_array_equal(p_c, p_t.numpy())
