"""PyTorch index lookup and CSR hit expansion against the JAX reference, on
the same tables (DeviceIndex.from_arrays takes the JAX index's fields)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.index import build as jbuild  # noqa: E402
from rawhash_tpu.index import device as jidx  # noqa: E402
from rawhash_tpu.pore import synthetic_pore as jax_pore  # noqa: E402
from rawhash_tpu_torch.index import build as tbuild  # noqa: E402
from rawhash_tpu_torch.index import device as tidx  # noqa: E402
from rawhash_tpu_torch.pore import synthetic_pore  # noqa: E402
from rawhash_tpu_torch.synthetic import options  # noqa: E402


@pytest.fixture(scope="module")
def tables():
    """The same genome indexed by each package with its own options: the
    port's index, the JAX package's device tables, and the port's tables
    made from those."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    records = [("chr1", genome), ("chr2", genome[:900])]
    index = tbuild.build_index_from_sequences(records, synthetic_pore(k=6),
                                              options("sensitive")[0])
    jiopt = jcfg.IndexOptions()
    jcfg.set_preset("sensitive", jiopt, jcfg.MapOptions())
    jindex = jbuild.build_index_from_sequences(records, jax_pore(k=6), jiopt)
    for name in ("keys", "offsets", "pos", "seq_lens"):
        np.testing.assert_array_equal(getattr(index, name), getattr(jindex, name))
    jd = jidx.DeviceIndex.from_host(jindex)
    td = tidx.DeviceIndex.from_arrays(
        np.asarray(jd.keys), np.asarray(jd.offsets), np.asarray(jd.pos_id),
        np.asarray(jd.pos_ps), np.asarray(jd.prefix), jd.n_seq,
        jd.prefix_bits, jd.bucket_levels, "cpu",
    )
    return index, jd, td


def _queries(index, rng, b, s):
    keys = index.keys.astype(np.uint32)
    hashes = np.where(rng.random((b, s)) < 0.6,
                      keys[rng.integers(0, keys.shape[0], (b, s))],
                      rng.integers(0, 2**32, (b, s), dtype=np.uint64).astype(np.uint32))
    valid = rng.random((b, s)) < 0.9
    return hashes.astype(np.uint32), valid


def test_from_host_equals_from_arrays(tables):
    index, _, td = tables
    th = tidx.DeviceIndex.from_host(index, "cpu")
    for a, c in ((th.keys, td.keys), (th.offsets, td.offsets),
                 (th.pos, td.pos), (th.prefix, td.prefix)):
        assert torch.equal(a, c)
    assert (th.prefix_bits, th.bucket_levels, th.n_seq) == (
        td.prefix_bits, td.bucket_levels, td.n_seq)


@pytest.mark.parametrize("a_cap", [16, 64, 512])
def test_lookup_and_expand_bit_exact(tables, a_cap):
    index, jd, td = tables
    rng = np.random.default_rng(a_cap)
    hashes, valid = _queries(index, rng, 4, 96)
    sj, cj = jidx.lookup_counts(jd, jnp.asarray(hashes), jnp.asarray(valid))
    st, ct = tidx.lookup_counts(
        td, torch.from_numpy(hashes.astype(np.int64)), torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.numpy().sum() > 0

    seed_j, id_j, ps_j, sv_j, nh_j, ov_j = jidx.expand_hits(jd, sj, cj, a_cap)
    seed_t, hit_t, sv_t, nh_t, ov_t = tidx.expand_hits(td, st, ct, a_cap)
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j))
    np.testing.assert_array_equal(seed_t.numpy(), np.asarray(seed_j))
    np.testing.assert_array_equal(nh_t.numpy(), np.asarray(nh_j))
    np.testing.assert_array_equal(ov_t.numpy(), np.asarray(ov_j))
    hit = hit_t.numpy()
    np.testing.assert_array_equal(hit >> 32, np.asarray(id_j).astype(np.int64))
    np.testing.assert_array_equal(hit & 0xFFFFFFFF, np.asarray(ps_j).astype(np.int64))
