"""Chain backtracking and compaction: the plain PyTorch versions against the
JAX package's lockstep backtrack and both Pallas backtrack kernels (in
interpret mode), and the CUDA kernel's per-read function
(csrc/chain_backtrack.cuh, built here with g++) against the plain version,
bit for bit.  The kernel itself runs on a card in test_torch_cuda.py."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu.chain import backtrack_device as jbt  # noqa: E402
from rawhash_tpu.chain.backtrack_pallas import backtrack_pallas  # noqa: E402
from rawhash_tpu.chain.backtrack_pallas_big import (  # noqa: E402
    backtrack_pallas_big, compact_from_chain_stats as jax_compact_stats,
)
from rawhash_tpu.chain.device import chain_fill_batch as jax_fill  # noqa: E402
from rawhash_tpu_torch._build import CSRC  # noqa: E402
from rawhash_tpu_torch.chain import backtrack_device as tbt  # noqa: E402
from rawhash_tpu_torch.chain.backtrack import (  # noqa: E402
    candidates, chain_backtrack, compact_from_chain_stats,
)
from rawhash_tpu_torch.synthetic import random_chains  # noqa: E402

SPAN = 13
PRM = dict(min_cnt=2, min_sc=20, max_drop=500)


def clustered(seed, b=3, n=256):
    """Sorted anchors along a few diagonals plus noise (the fixture of the
    JAX package's backtrack tests), and f/p from the JAX fill."""
    rng = np.random.default_rng(seed)
    n_live = rng.integers(20, n, size=b).astype(np.int32)
    key = np.zeros((b, n), np.uint32)
    tpos = np.full((b, n), 0x7FFFFFFF, np.int32)
    qpos = np.zeros((b, n), np.int32)
    for r in range(b):
        ks, ts, qs = [], [], []
        while len(ks) < n_live[r]:
            run = min(int(rng.integers(3, 25)), int(n_live[r]) - len(ks))
            k0 = int(rng.integers(0, 3)) | (int(rng.integers(0, 2)) << 31)
            t0, q0 = int(rng.integers(0, 5000)), int(rng.integers(0, 800))
            step = rng.integers(5, 40, size=run)
            ks += [k0] * run
            ts += (t0 + np.cumsum(step)).tolist()
            qs += (q0 + np.cumsum(step + rng.integers(-3, 4, size=run))).tolist()
        order = np.lexsort((ts, ks))
        m = int(n_live[r])
        key[r, :m] = np.asarray(ks, np.uint32)[order]
        tpos[r, :m] = np.asarray(ts, np.int32)[order]
        qpos[r, :m] = np.clip(np.asarray(qs, np.int32), 0, None)[order]
    f, p = jax_fill(jnp.asarray(key), jnp.asarray(tpos), jnp.asarray(qpos),
                    jnp.asarray(n_live), q_span=SPAN, max_dist_t=2500,
                    max_dist_q=2500, bw=500, max_iter=64, chn_pen_gap=0.104,
                    chn_pen_skip=0.0)
    return key, tpos, qpos, n_live, np.asarray(f), np.asarray(p)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k_cap", [64, 1])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ref", ["lockstep", "pallas", "pallas_big"])
def test_plain_backtrack_matches_jax(ref, seed, k_cap):
    key, tpos, qpos, n_live, f, p = clustered(seed)
    kw = dict(PRM, k_cap=k_cap)
    fj, pj, nj = jnp.asarray(f), jnp.asarray(p), jnp.asarray(n_live)
    got = chain_backtrack(T(f), T(p), T(n_live), T(tpos), T(qpos), **kw,
                          q_span=SPAN)
    if ref == "pallas_big":  # the chain-stat contract, all ten outputs
        want = backtrack_pallas_big(fj, pj, nj, jnp.asarray(tpos),
                                    jnp.asarray(qpos), **kw, q_span=SPAN,
                                    interpret=True)
        assert len(want) == len(got) == 10
    elif ref == "pallas":
        want = backtrack_pallas(fj, pj, nj, **kw, interpret=True)
    else:
        want = jbt.backtrack_batch(fj, pj, nj, **kw)
        # the unmasked lockstep state, stale claims past n_v included
        lock = tbt.backtrack_batch(T(f), T(p), T(n_live), **kw)
        for a, c in zip(want, lock):
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    nu, nv = got[2].numpy(), got[4].numpy()
    for a, c in zip(want, got):
        a, c = np.asarray(a), c.numpy()
        if ref != "pallas_big" and a.ndim == 2:  # compare the live prefix
            lim = nv if a.shape[1] == f.shape[1] else nu
            a = np.where(np.arange(a.shape[1])[None, :] < lim[:, None], a, 0)
        np.testing.assert_array_equal(c, a)
    if k_cap == 1:
        assert got[5].numpy().max() > 0  # chains were lost to k_cap
    assert nu.min() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compaction_matches_jax(seed):
    """compact_from_chain_stats against the JAX package's function of that
    name and its compact_batch; the port's compact_batch against the JAX
    one: summaries of the live chains and the carried prefix."""
    key, tpos, qpos, n_live, f, p = clustered(seed)
    kw = dict(PRM, k_cap=64)
    p_out = 128
    kj, tj, qj = jnp.asarray(key), jnp.asarray(tpos), jnp.asarray(qpos)
    stats_j = backtrack_pallas_big(jnp.asarray(f), jnp.asarray(p),
                                   jnp.asarray(n_live), tj, qj, **kw,
                                   q_span=SPAN, interpret=True)
    u_sc, u_cnt, n_u, v, n_v, _, u_ml, u_bl, u_lo, u_hi = stats_j
    want = jax_compact_stats(u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u, v, n_v,
                             kj, tj, qj, q_span=SPAN, p_out=p_out)
    lock = jbt.backtrack_batch(jnp.asarray(f), jnp.asarray(p),
                               jnp.asarray(n_live), **kw)
    want_b = jbt.compact_batch(*lock[:5], kj, tj, qj, q_span=SPAN)

    planes = (T(key.view(np.int32)), T(tpos), T(qpos))
    stats = chain_backtrack(T(f), T(p), T(n_live), T(tpos), T(qpos), **kw,
                            q_span=SPAN)
    s_u_sc, s_u_cnt, s_n_u, s_v, s_n_v, _, s_ml, s_bl, s_lo, s_hi = stats
    asc, order, summ = compact_from_chain_stats(
        s_u_sc, s_u_cnt, s_ml, s_bl, s_lo, s_hi, s_n_u, s_v, s_n_v, *planes,
        p_out=p_out,
    )
    np.testing.assert_array_equal(asc.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(summ.numpy(), np.asarray(want[2]))
    asc_b, order_b, summ_b = tbt.compact_batch(*stats[:5], *planes, q_span=SPAN)
    nu, nv = s_n_u.numpy(), s_n_v.numpy()
    for i in range(key.shape[0]):
        for s in (summ_b.numpy(), np.asarray(want_b[2])):
            np.testing.assert_array_equal(summ.numpy()[i, :nu[i]], s[i, :nu[i]])
        np.testing.assert_array_equal(asc_b.numpy()[i, :nv[i]],
                                      np.asarray(want_b[0])[i, :nv[i]])
        take = min(nv[i], p_out)
        np.testing.assert_array_equal(asc.numpy()[i, :take],
                                      asc_b.numpy()[i, :take])
    assert nu.min() > 0


def test_cpu_dispatch_is_plain_and_not_counted():
    f, p, n_anchors, tpos, qpos = map(T, random_chains(4, 2, 300, 20))
    before = (chain_backtrack.launches, chain_backtrack.max_width)
    kw = dict(PRM, k_cap=8, q_span=SPAN)
    got = chain_backtrack(f, p, n_anchors, tpos, qpos, **kw)
    want = tbt.backtrack_plain(f, p, n_anchors, tpos, qpos, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert (chain_backtrack.launches, chain_backtrack.max_width) == before


HARNESS = r"""
#include <vector>
#include "chain_backtrack.cuh"
extern "C" void backtrack(const int* zf, const int* zi, const int* f,
    const int* p, const int* tpos, const int* qpos, int b, int n, int k_cap,
    int min_cnt, int min_sc, int max_drop, int q_span, int* v, int* u,
    int* counts) {
  RhBtParams P = {n, k_cap, min_cnt, min_sc, max_drop, q_span};
  for (int r = 0; r < b; ++r) {
    std::vector<uint32_t> claimed((n + 31) / 32, 0u);
    const size_t a = (size_t)r * n;
    int* ur = u + (size_t)r * 6 * k_cap;  // six chain rows of this read
    RhBtCounts c = rh_backtrack_read(zf + a, zi + a, f + a, p + a, tpos + a,
        qpos + a, claimed.data(), v + a, ur, ur + k_cap, ur + 2 * k_cap,
        ur + 3 * k_cap, ur + 4 * k_cap, ur + 5 * k_cap, P);
    counts[3 * r] = c.n_u;
    counts[3 * r + 1] = c.n_v;
    counts[3 * r + 2] = c.ovf;
  }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The kernel's per-read function built as host C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    d = tmp_path_factory.mktemp("bt_harness")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{CSRC}", str(d / "harness.cpp"), "-o", str(so)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.backtrack.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 3
    return lib


@pytest.mark.parametrize("b,n,n_heads,k_cap", [
    (4, 1024, 60, 64),  # K2's regime
    (2, 33024, 120, 64),  # K3's: anchor indices past 32768
    (3, 1024, 60, 3),  # chains lost to k_cap
    (2, 33024, 120, 5),
])
def test_kernel_read_matches_plain(harness, b, n, n_heads, k_cap):
    f, p, n_anchors, tpos, qpos = random_chains(n, b, n, n_heads)
    z_f, z_idx = (t.numpy() for t in candidates(T(f), T(n_anchors)))
    v = np.zeros((b, n), np.int32)
    u = np.zeros((b, 6, k_cap), np.int32)
    counts = np.zeros((b, 3), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    harness.backtrack(
        ptr(z_f), ptr(z_idx), ptr(f), ptr(p), ptr(tpos), ptr(qpos), b, n,
        k_cap, PRM["min_cnt"], PRM["min_sc"], PRM["max_drop"], SPAN,
        ptr(v), ptr(u), ptr(counts),
    )
    want = [t.numpy() for t in tbt.backtrack_plain(
        *map(T, (f, p, n_anchors, tpos, qpos)), **PRM, k_cap=k_cap, q_span=SPAN,
    )]
    got = [u[:, 0], u[:, 1], counts[:, 0], v, counts[:, 1], counts[:, 2],
           u[:, 2], u[:, 3], u[:, 4], u[:, 5]]
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c, a)
    if n > 32768:  # chains started past index 32768
        assert u[:, 5].max() > 32768
    if k_cap < 10:
        assert counts[:, 2].min() > 0
