"""PyTorch event detection against the JAX reference on identical inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu.signal import events as jev  # noqa: E402
from rawhash_tpu_torch.signal import events as tev  # noqa: E402
from rawhash_tpu_torch.synthetic import signal_chunk  # noqa: E402


@pytest.mark.parametrize("n", [5, 16, 33, 255, 1000, 4000, 4001])
def test_ordered_sums_match_reference_order(n):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 3, (6, n)).astype(np.float32)
    got_sum = tev.ordered_sum(torch.from_numpy(x)).numpy()
    got_cum = tev.ordered_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got_sum, np.asarray(jnp.sum(jnp.asarray(x), axis=1)))
    np.testing.assert_array_equal(got_cum, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("seed,b,l,e_cap", [(1, 4, 4000, 768), (2, 3, 1500, 256)])
def test_detect_events_batch_matches_jax(seed, b, l, e_cap):
    rng = np.random.default_rng(seed)
    params = dict(window_length1=3, window_length2=9, threshold1=4.0,
                  threshold2=3.5, peak_height=0.4, e_cap=e_cap)
    jcarry = jev.NormCarry.zeros(b)
    tcarry = tev.NormCarry.zeros(b, "cpu")
    # two chunks, so the normalisation carry is exercised too
    for chunk in range(2):
        sig = signal_chunk(rng, b, l)
        slen = rng.integers(l // 2, l + 1, b).astype(np.int32)
        slen[0] = l
        if chunk == 1:
            slen[-1] = 0
        ev_j, n_j, jcarry = jev.detect_events_batch(
            jnp.asarray(sig), jnp.asarray(slen), jcarry, **params
        )
        ev_t, n_t, tcarry = tev.detect_events_batch(
            torch.from_numpy(sig), torch.from_numpy(slen), tcarry, **params
        )
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
        np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-5, atol=1e-5)
        for a, c in zip(tcarry, jcarry):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)


def test_dense_compact_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(5, 40)).astype(np.float32)
    keep = rng.random((5, 40)) < 0.4
    out_t, n_t = tev.dense_compact(torch.from_numpy(vals), torch.from_numpy(keep))
    out_j, n_j = jev.dense_compact(jnp.asarray(vals), jnp.asarray(keep))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
