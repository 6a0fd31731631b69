"""The port's standalone backtrack + compaction (rawhash_tpu_torch/chain/
backtrack_device.py::backtrack_compact) against the JAX package's
(rawhash_tpu/chain/backtrack_device.py::backtrack_compact), on the CPU, on
the inputs of tests/test_backtrack_device.py: the same anchors, with f and p
from the JAX chain_fill_batch, carried across as numpy.

The two take different routes to the same outputs.  JAX runs the lockstep
backtrack (backtrack_batch), then compact_batch; the port runs
chain_backtrack (on CPU tensors its plain version), then
compact_from_chain_stats at p_out = N.  Tolerance 0: summaries, n_u, n_v
and ovf are compared whole (the summary rows past n_u too), asc on each
row's first n_v slots.  Past n_v nothing is compared: there JAX's v may
still hold the claims of rejected chains and the port's holds 0, and both
compactions write 0 into asc."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402
from test_backtrack_device import SPAN, _random_anchors  # noqa: E402

from rawhash_tpu.chain.backtrack_device import (  # noqa: E402
    backtrack_compact as jax_backtrack_compact,
)
from rawhash_tpu.chain.device import chain_fill_batch as jax_fill  # noqa: E402
from rawhash_tpu_torch.chain.backtrack import chain_backtrack  # noqa: E402
from rawhash_tpu_torch.chain.backtrack_device import (  # noqa: E402
    backtrack_batch, backtrack_compact, compact_batch,
)

FILL = dict(q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=64,
            chn_pen_gap=0.104, chn_pen_skip=0.0)
PRM = dict(min_cnt=2, min_sc=20, max_drop=500, q_span=SPAN)


def anchors(seed, all_live=False):
    """tests/test_backtrack_device.py's inputs: 5 rows of 20-255 live
    anchors (test_backtrack_matches_host), or 2 full rows of 256
    (test_chain_overflow_counts); f and p from the JAX fill."""
    rng = np.random.default_rng(seed)
    b, n_cap = (2, 256) if all_live else (5, 256)
    n_live = (np.full(b, n_cap) if all_live
              else rng.integers(20, n_cap, size=b)).astype(np.int32)
    keys = np.zeros((b, n_cap), np.uint32)
    tposs = np.zeros((b, n_cap), np.int32)
    qposs = np.zeros((b, n_cap), np.int32)
    for i in range(b):
        keys[i], tposs[i], qposs[i] = _random_anchors(
            rng, n_cap if all_live else int(n_live[i]), n_cap)
    f, p = jax_fill(jnp.asarray(keys), jnp.asarray(tposs), jnp.asarray(qposs),
                    jnp.asarray(n_live), **FILL)
    return np.asarray(f), np.asarray(p), n_live, keys, tposs, qposs


def both(inputs, k_cap):
    """(JAX's outputs, the port's) as numpy: summaries, n_u, asc, n_v, ovf."""
    f, p, n_live, keys, tposs, qposs = inputs
    kw = dict(PRM, k_cap=k_cap)
    want = jax_backtrack_compact(*map(jnp.asarray, inputs), **kw)
    got = backtrack_compact(*(torch.from_numpy(np.array(x)) for x in
                              (f, p, n_live, keys.view(np.int32), tposs, qposs)),
                            **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def assert_same(want, got):
    names = ("summaries", "n_u", "asc", "n_v", "ovf")
    for name, w, g in zip(names, want, got):
        assert g.dtype == np.int32 and g.shape == w.shape, name
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    for row, nv in enumerate(want[3]):
        np.testing.assert_array_equal(got[2][row, :nv], want[2][row, :nv])


@pytest.mark.parametrize("seed", range(5))
def test_backtrack_compact_matches_jax(seed):
    inputs = anchors(seed)
    want, got = both(inputs, k_cap=64)
    assert_same(want, got)
    assert want[1].min() > 0 and want[4].max() == 0
    # rows past n_u are there to be compared
    assert want[1].max() < 64


@pytest.mark.parametrize("k_cap", [1, 64])
def test_backtrack_compact_matches_jax_on_k_cap_overflow(k_cap):
    """test_chain_overflow_counts's rows: at k_cap 1 chains are lost."""
    want, got = both(anchors(5, all_live=True), k_cap=k_cap)
    assert_same(want, got)
    assert (want[4].max() > 0) == (k_cap == 1)


@pytest.mark.parametrize("seed", range(2))
def test_backtrack_compact_is_compact_batch_of_the_lockstep(seed):
    """Within the port: backtrack_compact equals compact_batch on
    backtrack_batch's chains, summaries whole, asc up to n_v; the CPU route
    counts no kernel launch."""
    f, p, n_live, keys, tposs, qposs = (torch.from_numpy(np.array(x))
                                        for x in anchors(seed))
    keys = keys.view(torch.int32)
    before = chain_backtrack.launches
    got = backtrack_compact(f, p, n_live, keys, tposs, qposs, **PRM, k_cap=8)
    assert chain_backtrack.launches == before
    prm = {k: v for k, v in PRM.items() if k != "q_span"}
    u_sc, u_cnt, n_u, v, n_v, ovf = backtrack_batch(f, p, n_live, **prm, k_cap=8)
    asc, _, summ = compact_batch(u_sc, u_cnt, n_u, v, n_v, keys, tposs, qposs,
                                 q_span=SPAN)
    assert torch.equal(got[0], summ) and torch.equal(got[1], n_u)
    assert torch.equal(got[3], n_v) and torch.equal(got[4], ovf)
    for row, nv in enumerate(n_v.tolist()):
        assert torch.equal(got[2][row, :nv], asc[row, :nv])


def test_backtrack_compact_refuses_another_device():
    args = [torch.zeros((2, 8), dtype=torch.int32, device="meta") for _ in range(6)]
    args[2] = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        backtrack_compact(*args, **PRM, k_cap=4)
