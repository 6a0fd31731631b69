"""The PyTorch chunk step against the JAX chunk step on identical inputs:
sorted anchor planes, chain scores and per-read scalars, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.index import build as jbuild  # noqa: E402
from rawhash_tpu.index.device import DeviceIndex as JaxIndex  # noqa: E402
from rawhash_tpu.map import device_step as jstep  # noqa: E402
from rawhash_tpu.pore import synthetic_pore as jax_pore  # noqa: E402
from rawhash_tpu.signal.events import NormCarry as JaxCarry  # noqa: E402
from rawhash_tpu_torch.index.build import update_mid_occ  # noqa: E402
from rawhash_tpu_torch.index.device import DeviceIndex  # noqa: E402
from rawhash_tpu_torch.map import device_step as tstep  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.signal.events import NormCarry  # noqa: E402
from rawhash_tpu_torch.synthetic import deployment, random_genome  # noqa: E402


@pytest.mark.parametrize("preset,p_cap", [("sensitive", 16), ("viral", 8)])
def test_chunk_step_matches_jax(preset, p_cap):
    index, mopt, reads = deployment(6000, preset, 4, 500, 512, seed=3)
    update_mid_occ(mopt, index)
    # the JAX package indexes the same genome with its own options
    genome = random_genome(6000, np.random.default_rng(3))
    jiopt = jcfg.IndexOptions()
    jcfg.set_preset(preset, jiopt, jcfg.MapOptions())
    jindex = jbuild.build_index_from_sequences([("chr1", genome)],
                                               jax_pore(k=6), jiopt)
    io = index.opts
    b, l_chunk, a_cap = 4, 4000, 256
    sig = np.zeros((b, l_chunk), np.float16)
    slen = np.zeros(b, np.int32)
    for i, (_, s, _, _) in enumerate(reads):
        n = min(l_chunk, s.shape[0]) if i < 3 else 0  # last row: no signal
        sig[i, :n] = s[:n]
        slen[i] = n
    rng = np.random.default_rng(9)
    # carried anchors as a previous chunk would leave them (tid 0, both strands)
    prev_key = (rng.integers(0, 2, (b, p_cap)).astype(np.uint32) << 31)
    prev_tpos = rng.integers(0, 6000, (b, p_cap)).astype(np.int32)
    prev_qpos = rng.integers(0, 60, (b, p_cap)).astype(np.int32)
    n_prev = np.array([0, p_cap, p_cap // 2, 0], np.int32)
    ev_offset = np.array([0, 50, 7, 0], np.int32)
    carry = (np.array([0, 9.0e4, 1.0e5, 0], np.float32),
             np.array([0, 8.2e6, 9.1e6, 0], np.float32),
             np.array([0, 1000, 1100, 0], np.int32))

    fp = fill_params(io, mopt)
    params = dict(
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k, fine_min=io.fine_min,
        fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mopt.window_length1, window_length2=mopt.window_length2,
        threshold1=mopt.threshold1, threshold2=mopt.threshold2,
        peak_height=mopt.peak_height, e_cap=mopt.max_events_per_chunk,
        a_cap=a_cap, min_events=mopt.min_events, mid_occ=int(mopt.mid_occ),
        **{k: v for k, v in fp.items() if k != "q_span"},
    )
    pack = np.concatenate([prev_key.view(np.int32), prev_tpos, prev_qpos,
                           n_prev[:, None], slen[:, None]], axis=1)
    jout = jstep.chunk_step(
        JaxIndex.from_host(jindex), jnp.asarray(sig),
        JaxCarry(*(jnp.asarray(c) for c in carry)), jnp.asarray(ev_offset),
        jnp.asarray(pack), jnp.zeros(b, jnp.int32), jnp.zeros(1, jnp.int32),
        **params, all_vs_all=False, wide=True,
    )
    tout = tstep.chunk_step(
        DeviceIndex.from_host(index, "cpu"), torch.from_numpy(sig),
        torch.from_numpy(slen), NormCarry(*(torch.from_numpy(c) for c in carry)),
        torch.from_numpy(ev_offset), torch.from_numpy(prev_key.astype(np.int64)),
        torch.from_numpy(prev_tpos), torch.from_numpy(prev_qpos),
        torch.from_numpy(n_prev), **params,
    )
    scal = np.asarray(jout.scalars)
    for col, t in enumerate((tout.n_anchors, tout.rep_len, tout.n_ev,
                             tout.processed, tout.overflow, tout.ev_offset)):
        np.testing.assert_array_equal(t.numpy().astype(np.int32), scal[:, col])
    assert tout.n_anchors.numpy()[:3].min() > p_cap  # the rows made anchors
    packed = np.asarray(jout.packed)
    for i in range(b):
        n = int(scal[i, 0])
        for w, t in enumerate((tout.key, tout.tpos, tout.qpos, tout.f, tout.p)):
            np.testing.assert_array_equal(t.numpy()[i, :n], packed[i, :n, w])
    for a, c in zip(tout.carry, jout.carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)
