"""PyTorch event detection against the JAX reference on identical inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax  # noqa: E402
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


def test_sqrt_rn_matches_xla_sqrt_bit_for_bit():
    """sqrt_rn, the plain path's f32 square root, equals XLA's (jnp.sqrt on
    the CPU, as the JAX package takes it) and numpy's, both rounded to
    nearest, bit for bit on 2^20 random normal f32 values and 0, the
    smallest normal, the largest finite value and inf.  torch's own f32
    sqrt on the CPU may not (its vectorised routine is off by an ulp on
    ~0.6% of these values with AVX-512); where it differs, by one ulp."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0x00800000, 0x7F800000, 1 << 20, dtype=np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        np.float32([0.0, tev.FLT_MIN, tev.FLT_MAX, np.inf])])
    got = tev.sqrt_rn(torch.from_numpy(x)).numpy().view(np.int32)
    xla = np.asarray(jax.jit(jnp.sqrt)(x)).view(np.int32)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, np.sqrt(x).view(np.int32))
    off = torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32) - xla
    assert np.abs(off).max() <= 1


def test_plain_normalisation_matches_jax_bit_for_bit(monkeypatch):
    """The plain path's normalised signal (the signal less the mean over
    the std, as dense_compact gets it) and its carry equal the JAX
    package's bit for bit, on 512 rows over two chunks (the second on the
    first's carry).  With torch's f32 sqrt in place of sqrt_rn, the rows
    whose std it rounds otherwise, and only those, differ from the JAX
    package's."""
    b, l = 512, 1000
    prm = dict(window_length1=3, window_length2=9, threshold1=4.0,
               threshold2=3.5, peak_height=0.4, e_cap=256)
    seen = {}

    def spy(mod, key):
        fn = mod.dense_compact

        def dense_compact(values, keep):
            seen[key] = values
            return fn(values, keep)
        monkeypatch.setattr(mod, "dense_compact", dense_compact)
    spy(jev, "jax")
    spy(tev, "torch")

    @jax.jit
    def jax_stage(sig, slen, carry):
        # the JAX package's stage traced here, its normalised signal an output
        out = jev.detect_events_batch.__wrapped__(sig, slen, carry, **prm)
        return out[2], seen["jax"]

    sqrt_rn = tev.sqrt_rn
    roots = []

    def torch_sqrt(x):
        if x.dim() == 1:  # the std's; the t-statistics' are [B, L]
            roots.append(x)
        return torch.sqrt(x)

    rng = np.random.default_rng(23)
    jcarry = jev.NormCarry.zeros(b)
    tcarry = tev.NormCarry.zeros(b, "cpu")
    for chunk in range(2):
        sig = signal_chunk(rng, b, l)
        slen = rng.integers(l // 2, l + 1, b).astype(np.int32)
        jcarry, jnorm = jax_stage(jnp.asarray(sig), jnp.asarray(slen), jcarry)
        jnorm = np.asarray(jnorm).view(np.int32)
        args = (torch.from_numpy(sig), torch.from_numpy(slen), tcarry)
        tcarry = tev.detect_events_batch_plain(*args, **prm)[2]
        np.testing.assert_array_equal(seen["torch"].numpy().view(np.int32), jnorm)
        for a, c in zip(tcarry, jcarry):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(c).view(np.int32))
        with monkeypatch.context() as m:
            m.setattr(tev, "sqrt_rn", torch_sqrt)
            tev.detect_events_batch_plain(*args, **prm)
        rounded = (torch.sqrt(roots[-1]) != sqrt_rn(roots[-1])).numpy()
        differ = (seen["torch"].numpy().view(np.int32) != jnorm).any(axis=1)
        np.testing.assert_array_equal(differ, rounded)


def test_dense_compact_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(5, 40)).astype(np.float32)
    keep = rng.random((5, 40)) < 0.4
    out_t, n_t = tev.dense_compact(torch.from_numpy(vals), torch.from_numpy(keep))
    out_j, n_j = jev.dense_compact(jnp.asarray(vals), jnp.asarray(keep))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
