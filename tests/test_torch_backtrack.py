"""Chain backtracking and compaction: the plain PyTorch versions against the
JAX package's lockstep backtrack and both Pallas backtrack kernels (in
interpret mode), and the CUDA kernel's per-read functions
(csrc/chain_backtrack.cuh, built here with g++: the serial algorithm and
the kernel's rounds with the lanes as a loop) against the plain version,
bit for bit, with the kernel's candidate order against the full one cut at
min_sc.  The kernel itself runs on a card in test_torch_cuda.py."""

import ctypes
import functools
import shutil

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
from rawhash_tpu_torch._build import load_host_library  # noqa: E402
from rawhash_tpu_torch.chain import backtrack_device as tbt  # noqa: E402
from rawhash_tpu_torch.chain.backtrack import (  # noqa: E402
    backtrack_host_serial, candidate_order, candidates_cut, chain_backtrack,
    compact_from_chain_stats, host_array, host_outputs, ptr,
)
from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.index.build import update_mid_occ  # noqa: E402
from rawhash_tpu_torch.index.device import DeviceIndex  # noqa: E402
from rawhash_tpu_torch.map.device_step import chunk_step  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.signal.events import NormCarry  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    clustered_anchors, deployment, random_chains, sparse_anchors,
)

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


def plain(args, k_cap):
    return [t.numpy() for t in tbt.backtrack_plain(
        *map(T, args), **PRM, k_cap=k_cap, q_span=SPAN)]


@pytest.fixture(scope="module")
def host_lib():
    """The kernel's header built for the host (g++)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    return load_host_library("chain_backtrack")


def backtrack_host_rounds(f, p, n_anchors, tpos, qpos, *, min_cnt, min_sc,
                          max_drop, k_cap, q_span, depth):
    """rh_backtrack_rounds (csrc/chain_backtrack.cuh), the kernel's rounds,
    on the host with the 32 lanes as a loop (csrc/chain_backtrack_host.cpp),
    on `candidate_order`, at a staging depth: the ten outputs as numpy
    int32 arrays, in chain_backtrack's order."""
    lib = load_host_library("chain_backtrack")
    f, p, n_anchors, tpos, qpos = map(host_array, (f, p, n_anchors, tpos, qpos))
    z_f, z_idx, n_cand, _ = candidate_order(T(f), T(n_anchors), min_sc)
    z_f, z_idx, n_cand = map(host_array, (z_f, z_idx, n_cand))
    b, n = f.shape
    v = np.zeros((b, n), np.int32)
    u = np.zeros((b, 6, k_cap), np.int32)
    counts = np.zeros((b, 3), np.int32)
    lib.rh_bt_rounds.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p] * 3
    lib.rh_bt_rounds(ptr(z_f), ptr(z_idx), ptr(n_cand), ptr(n_anchors),
                     ptr(f), ptr(p), ptr(tpos), ptr(qpos), b, n,
                     z_f.shape[1], k_cap, min_cnt, min_sc, max_drop, q_span,
                     depth, ptr(v), ptr(u), ptr(counts))
    return host_outputs(u, counts, v)


@pytest.mark.parametrize("b,n,n_heads,k_cap", [
    (4, 1024, 60, 64),  # K2's regime
    (2, 33024, 120, 64),  # K3's: anchor indices past 32768
    (3, 1024, 60, 3),  # chains lost to k_cap
    (2, 33024, 120, 5),
])
def test_kernel_read_matches_plain(host_lib, b, n, n_heads, k_cap):
    """rh_backtrack_read, the serial algorithm of the kernel's header."""
    args = random_chains(n, b, n, n_heads)
    got, work = backtrack_host_serial(*args, **PRM, k_cap=k_cap, q_span=SPAN)
    want = plain(args, k_cap)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c, a)
    u_hi, ovf = got[9], got[5]
    if n > 32768:  # chains started past index 32768
        assert u_hi.max() > 32768
    if k_cap < 10:
        assert ovf.min() > 0
    # the work counts agree with the outputs
    np.testing.assert_array_equal(work[:, 4], got[2])
    np.testing.assert_array_equal(work[:, 5], got[4])


def crafted_row():
    """One row whose first round meets every border of a staged walk, in
    candidate order (f descending):
      20 (f 1600, root)      rejected (cbest 1 < min_cnt), claims 20;
      21 (f 1500, p 20)      s < 0 at the claimed 20: cbest 0, claims nothing;
      24 (f 1000)            24-23-22, then 21, unclaimed, drops by 1400 >
                             max_drop: the break, kept at end_i 22;
      4  (f 90)              walk 4-3-2-1-0-root: the root step is the peak;
      6  (f 88)              path 6-5-2-1-0 shares 2, 1, 0 with 4's, claimed
                             in this round: cut at 2, the claimed last step
                             scored (38 at end_i 2), kept;
      7  (f 80, p 6)         s < 0 at 6, claimed this round: cbest 0;
      59 (f 69, 45 steps)    a walk past every staging depth, to the root at
                             anchor 10;
    the rest is filler below min_sc.  Returns (f, p, n_anchors, tpos, qpos)."""
    n = 64
    f = np.full(n, 5, np.int32)
    p = np.full(n, -1, np.int32)
    chain = [i for i in range(10, 60) if not 20 <= i <= 24]
    for k, i in enumerate(chain):
        f[i], p[i] = 20 + k, chain[k - 1] if k else -1
    for i, (fi, pi) in {0: (13, -1), 1: (30, 0), 2: (50, 1), 3: (70, 2),
                        4: (90, 3), 5: (75, 2), 6: (88, 5), 7: (80, 6),
                        20: (1600, -1), 21: (1500, 20), 22: (100, 21),
                        23: (950, 22), 24: (1000, 23)}.items():
        f[i], p[i] = fi, pi
    assert (p < np.arange(n)).all()
    tpos = (np.arange(n) * 37).astype(np.int32)
    qpos = (np.arange(n) * 35 + (np.arange(n) % 3)).astype(np.int32)
    return f[None], p[None], np.array([n], np.int32), tpos[None], qpos[None]


@functools.lru_cache(maxsize=None)
def rounds_input(name):
    """(inputs, parameters, the plain outputs) of each input the rounds
    meet; the "_cnt1" ones keep one-anchor chains, so a candidate claimed
    earlier in its round (crafted_row's 5 and 3) would show if it were
    walked again."""
    prm = dict(PRM, q_span=SPAN)
    if name.endswith("_cnt1"):
        prm["min_cnt"] = 1
    if name.startswith("crafted"):
        args, prm["k_cap"] = crafted_row(), 8
    elif name.startswith(("clustered", "sparse")):
        gen = sparse_anchors(7, 2, 3000) if name == "sparse" else \
            clustered_anchors(7, 2, 1500)
        key, tpos, qpos, n_anchors = (
            torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in gen)
        f, p = chain_fill_batch(key, tpos, qpos, n_anchors, q_span=SPAN,
                                max_dist_t=2500, max_dist_q=2500, bw=500,
                                max_iter=200, chn_pen_gap=0.104, chn_pen_skip=0.0)
        args = tuple(x.numpy() for x in (f, p, n_anchors, tpos, qpos))
        prm["k_cap"] = 1024
    else:
        b, n, n_heads, prm["k_cap"] = {
            "k2": (4, 1024, 60, 64), "k3": (2, 33024, 120, 64),
            "k_cap": (3, 1024, 60, 3)}[name]
        args = random_chains(n, b, n, n_heads)
    want = [t.numpy() for t in tbt.backtrack_plain(*map(T, args), **prm)]
    return args, prm, want


def test_crafted_row_meets_every_border():
    """The plain outputs of crafted_row: the chains its docstring names."""
    (f, p, *_), _, want = rounds_input("crafted")
    u_sc, u_cnt, n_u, v, n_v, ovf, _, _, u_lo, u_hi = want
    chains = {int(u_hi[0, k]): (int(u_sc[0, k]), int(u_cnt[0, k]), int(u_lo[0, k]))
              for k in range(int(n_u[0]))}
    assert chains[4] == (90, 5, 0)  # to the root
    assert chains[6] == (38, 2, 5)  # cut at 2, claimed by 4's chain
    assert chains[59][1] == 45  # 45 steps to the root
    assert chains[24] == (900, 2, 23) and 21 not in v[0]  # the break
    assert 7 not in v[0] and 20 not in v[0]  # cbest 0; rejected
    # all of them candidates of the first round
    z_f, z_idx, n_cand, _ = candidate_order(T(f), T(np.array([64])), PRM["min_sc"])
    first = z_idx[0, -32:].tolist()
    assert all(i in first for i in (20, 21, 24, 4, 6, 59, 7))
    assert ovf[0] == 0


@pytest.mark.parametrize("depth", [0, 1, 2, 8, 16, 32])
@pytest.mark.parametrize("name", ["crafted", "crafted_cnt1", "k2", "k3", "k_cap",
                                  "clustered", "clustered_cnt1", "sparse"])
def test_kernel_rounds_match_plain(host_lib, name, depth):
    """rh_backtrack_rounds, the kernel's rounds with the lanes as a loop, on
    the compacted candidate order: bit-equal to the plain version at each
    staging depth (0: no walk staged, each resolved serially)."""
    args, prm, want = rounds_input(name)
    got = backtrack_host_rounds(*args, **prm, depth=depth)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c, a)
    if name == "k_cap":
        assert got[5].min() > 0
    if name == "k3":
        assert got[9].max() > 32768


def chunk_order_case():
    """f and n_anchors of a real chunk step: four sensitive reads of a
    simulated genome through the step up to the fill, no anchors carried
    in, row 2 without signal."""
    index, mopt, reads = deployment(6000, "sensitive", 4, 500, 512, seed=3)
    update_mid_occ(mopt, index)
    io = index.opts
    b, l_chunk = 4, 4000
    sig = np.zeros((b, l_chunk), np.float32)
    slen = np.zeros(b, np.int32)
    for i, (_, s, _, _) in enumerate(reads):
        slen[i] = 0 if i == 2 else min(l_chunk, s.shape[0])
        sig[i, :slen[i]] = s[:slen[i]]
    zeros = torch.zeros(b, dtype=torch.int32)
    out = chunk_step(
        DeviceIndex.from_host(index, "cpu"), T(sig), T(slen),
        NormCarry.zeros(b, "cpu"), zeros, torch.zeros((b, 8), dtype=torch.int64),
        torch.zeros((b, 8), dtype=torch.int32),
        torch.zeros((b, 8), dtype=torch.int32), zeros,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k, fine_min=io.fine_min,
        fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mopt.window_length1, window_length2=mopt.window_length2,
        threshold1=mopt.threshold1, threshold2=mopt.threshold2,
        peak_height=mopt.peak_height, e_cap=mopt.max_events_per_chunk,
        a_cap=512, min_events=mopt.min_events, mid_occ=int(mopt.mid_occ),
        **{k: v for k, v in fill_params(io, mopt).items() if k != "q_span"},
    )
    return out.f.numpy(), out.n_anchors.numpy().astype(np.int32)


def order_case(name):
    if name == "chunk":
        return chunk_order_case()
    rng = np.random.default_rng(3)
    b, n = 4, 300
    f = rng.integers(-50, 60, (b, n)).astype(np.int32)
    n_anchors = np.array([n, 200, 0, 17], np.int32)
    if name == "ties":  # few distinct values: long runs of equal f
        f = rng.choice(np.array([5, 20, 21, 40], np.int32), (b, n))
    elif name == "none":  # no candidate anywhere
        f[:] = 3
    elif name == "over":  # n_anchors past the width
        n_anchors = np.array([n + 5, n, 1, 299], np.int32)
    return f, n_anchors


@pytest.mark.parametrize("name", ["random", "ties", "none", "over", "chunk"])
def test_candidate_order_is_the_full_order_cut(name):
    """candidate_order (compacted, then sorted) against candidates() cut at
    min_sc: equal f values, pads, n_anchors = 0, no candidates at all, and
    the scores of a real chunk step."""
    f, n_anchors = order_case(name)
    if name == "chunk":
        assert (f >= PRM["min_sc"]).sum() > 0 and n_anchors.max() > 0
    z_f, z_idx, n_cand, a_max = candidate_order(T(f), T(n_anchors), PRM["min_sc"])
    want = candidates_cut(T(f), T(n_anchors), PRM["min_sc"], z_f.shape[1])
    for a, c in zip(want, (z_f, z_idx, n_cand)):
        assert torch.equal(a, c)
    live = np.arange(f.shape[1])[None, :] < n_anchors[:, None]
    np.testing.assert_array_equal(n_cand.numpy(), (live & (f >= PRM["min_sc"])).sum(1))
    assert z_f.shape[1] == max(int(n_cand.max()), 1)
    assert a_max == min(max(int(n_anchors.max()), 1), f.shape[1])
    assert n_cand[2] == 0
    c = z_f.shape[1]
    for r in range(f.shape[0]):  # the top of each row: (f, idx) ascending
        top = list(zip(z_f[r, c - int(n_cand[r]):].tolist(),
                       z_idx[r, c - int(n_cand[r]):].tolist()))
        assert top == sorted(top)
        assert all(fv >= PRM["min_sc"] for fv, _ in top)


def test_compare_backtrack_loads_another_checkout(monkeypatch):
    """profiling/compare_backtrack.py loads another checkout's package under
    its own name (this checkout here), whose chain_backtrack gives ours on
    the CPU; without a card it exits non-zero."""
    from pathlib import Path

    import rawhash_tpu_torch
    from rawhash_tpu_torch.profiling import compare_backtrack as cmp

    other = cmp.load_other(Path(rawhash_tpu_torch.__file__).parents[1])
    assert other.__name__ == f"{cmp.OTHER}.chain.backtrack"
    assert other.chain_backtrack is not chain_backtrack
    args = [T(x) for x in random_chains(3, 2, 300, 20)]
    kw = dict(PRM, k_cap=8, q_span=SPAN)
    assert all(torch.equal(a, c) for a, c in zip(other.chain_backtrack(*args, **kw),
                                                 chain_backtrack(*args, **kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cmp.main(["somewhere"]) == 1
    assert cmp.main([]) == 2
