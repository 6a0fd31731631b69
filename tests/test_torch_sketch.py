"""PyTorch sketching against the JAX reference: bit-exact hashes, seed
positions and validity on identical events."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.sketch import device as jsk  # noqa: E402
from rawhash_tpu.sketch.quantize import (  # noqa: E402
    dynamic_quantize_jnp, hash32_jnp, hash32_np,
)
from rawhash_tpu_torch.sketch import device as tsk  # noqa: E402
from rawhash_tpu_torch.sketch import quantize as tq  # noqa: E402
from rawhash_tpu_torch.sketch.quantize import dynamic_quantize, hash32  # noqa: E402
from rawhash_tpu_torch.synthetic import options  # noqa: E402


@pytest.mark.parametrize("ref", ["np", "jnp"])
def test_hash32_bit_exact(ref):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    keys[:3] = [0, 1, 0xFFFFFFFF]
    got = hash32(torch.from_numpy(keys.astype(np.int64))).numpy()
    want = hash32_np(keys) if ref == "np" else np.asarray(hash32_jnp(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("fine_range", [0.4, 0.6])
def test_dynamic_quantize_bit_exact(fine_range):
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(0, 1.2, 50000), np.linspace(-3, 3, 20001),
    ]).astype(np.float32)
    got = dynamic_quantize(torch.from_numpy(x), -2.0, 2.0, fine_range, 16).numpy()
    want = np.asarray(dynamic_quantize_jnp(jnp.asarray(x), -2.0, 2.0, fine_range, 16))
    np.testing.assert_array_equal(got, want)


def _events(rng, b, e_cap):
    ev = rng.normal(0, 1.0, (b, e_cap)).astype(np.float32)
    n_ev = rng.integers(e_cap // 3, e_cap + 1, b).astype(np.int32)
    n_ev[0] = 3  # fewer events than one seed needs
    ev[np.arange(e_cap)[None, :] >= n_ev[:, None]] = 0.0
    return ev, n_ev


@pytest.mark.parametrize("preset", ["sensitive", "viral", "faster"])
def test_sketch_batch_bit_exact(preset):
    def params(iopt):
        return dict(diff=iopt.diff, w=iopt.w, e=iopt.e, q=iopt.q, k=iopt.k,
                    fine_min=iopt.fine_min, fine_max=iopt.fine_max,
                    fine_range=iopt.fine_range)

    jiopt = jcfg.IndexOptions()
    jcfg.set_preset(preset, jiopt, jcfg.MapOptions())
    rng = np.random.default_rng(7)
    ev, n_ev = _events(rng, 5, 300)
    hj, qj, vj = jsk.sketch_batch(jnp.asarray(ev), jnp.asarray(n_ev),
                                  **params(jiopt))
    ht, qt, vt = tsk.sketch_batch(torch.from_numpy(ev), torch.from_numpy(n_ev),
                                  **params(options(preset)[0]))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_numpy_halves_match_jax_package():
    """The port's own numpy quantiser and hash (its host index build) equal
    the JAX package's."""
    from rawhash_tpu.sketch.quantize import dynamic_quantize_np

    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.5, 30000).astype(np.float32)
    np.testing.assert_array_equal(tq.dynamic_quantize_np(x, -2.0, 2.0, 0.4, 16),
                                  dynamic_quantize_np(x, -2.0, 2.0, 0.4, 16))
    keys = rng.integers(0, 2**32, 30000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tq.hash32_np(keys), hash32_np(keys))
