"""The device tail: the port's chunk_step_tail against the JAX package's on
the same index and signal, and the engine's device-tail path end to end on
the fixture, against the port's host tail and the JAX engine's device tail
(PAF columns 1-12), with the same switching rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.index import build as jbuild  # noqa: E402
from rawhash_tpu.index.device import DeviceIndex as JaxIndex  # noqa: E402
from rawhash_tpu.index.serialize import load_index as jax_load_index  # noqa: E402
from rawhash_tpu.map import device_step as jstep  # noqa: E402
from rawhash_tpu.map.engine import MappingEngine as JaxEngine  # noqa: E402
from rawhash_tpu.pore import synthetic_pore as jax_pore  # noqa: E402
from rawhash_tpu.signal.events import NormCarry as JaxCarry  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.index.build import update_mid_occ  # noqa: E402
from rawhash_tpu_torch.index.device import DeviceIndex  # noqa: E402
from rawhash_tpu_torch.index.serialize import load_index  # noqa: E402
from rawhash_tpu_torch.io.sigfile import read_signals  # noqa: E402
from rawhash_tpu_torch.map import device_step as tstep  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine, fill_params  # noqa: E402
from rawhash_tpu_torch.signal.events import NormCarry  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    deployment, options, random_genome, write_fixture,
)


def jax_index(genome_len, preset, seed):
    """The JAX package's index and options for synthetic.deployment's
    genome (the same numpy seed), built by the JAX package itself."""
    genome = random_genome(genome_len, np.random.default_rng(seed))
    iopt, mopt = jcfg.IndexOptions(), jcfg.MapOptions()
    jcfg.set_preset(preset, iopt, mopt)
    index = jbuild.build_index_from_sequences([("chr1", genome)],
                                              jax_pore(k=6), iopt)
    jbuild.update_mid_occ(mopt, index)
    return index, mopt


@pytest.mark.parametrize("preset,k_cap,p_out", [("sensitive", 64, 64),
                                                ("viral", 2, 16)])
def test_chunk_step_tail_matches_jax(preset, k_cap, p_out):
    index, mopt, reads = deployment(6000, preset, 4, 500, 512, seed=3)
    update_mid_occ(mopt, index)
    jidx, jmopt = jax_index(6000, preset, seed=3)
    for name in ("keys", "offsets", "pos"):  # both packages built one index
        np.testing.assert_array_equal(getattr(index, name), getattr(jidx, name))
    assert mopt.mid_occ == jmopt.mid_occ
    io = index.opts
    b, l_chunk, a_cap = 4, 4000, 256
    sig = np.zeros((b, l_chunk), np.float16)
    slen = np.zeros(b, np.int32)
    for i, (_, s, _, _) in enumerate(reads):
        n = min(l_chunk, s.shape[0]) if i < 3 else 0  # last row: no signal
        sig[i, :n] = s[:n]
        slen[i] = n
    rng = np.random.default_rng(9)
    # carried anchors as a previous chunk would leave them; row 2 finished
    # (inactive), so its carried anchors must be dropped
    p_in = 16
    prev_key = (rng.integers(0, 2, (b, p_in)).astype(np.uint32) << 31)
    prev_tpos = np.sort(rng.integers(0, 6000, (b, p_in)), axis=1).astype(np.int32)
    prev_qpos = np.sort(rng.integers(0, 60, (b, p_in)), axis=1).astype(np.int32)
    n_prev = np.array([0, p_in, p_in // 2, 0], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    ev_offset = np.array([0, 50, 7, 0], np.int32)
    carry = (np.array([0, 9.0e4, 1.0e5, 0], np.float32),
             np.array([0, 8.2e6, 9.1e6, 0], np.float32),
             np.array([0, 1000, 1100, 0], np.int32))

    params = dict(
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k, fine_min=io.fine_min,
        fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mopt.window_length1, window_length2=mopt.window_length2,
        threshold1=mopt.threshold1, threshold2=mopt.threshold2,
        peak_height=mopt.peak_height, e_cap=mopt.max_events_per_chunk,
        a_cap=a_cap, min_events=mopt.min_events, mid_occ=int(mopt.mid_occ),
        k_cap=k_cap, p_out=p_out, min_cnt=mopt.min_num_anchors,
        min_sc=mopt.min_chaining_score,
        **{k: v for k, v in fill_params(io, mopt).items() if k != "q_span"},
    )
    jout = jstep.chunk_step_tail(
        JaxIndex.from_host(jidx), jnp.asarray(sig),
        JaxCarry(*(jnp.asarray(c) for c in carry)), jnp.asarray(ev_offset),
        jnp.asarray(prev_key), jnp.asarray(prev_tpos), jnp.asarray(prev_qpos),
        jnp.asarray(n_prev), jnp.asarray(active), jnp.asarray(slen),
        jnp.zeros(b, jnp.int32), jnp.zeros(1, jnp.int32),
        **params, all_vs_all=False,
    )
    tout = tstep.chunk_step_tail(
        DeviceIndex.from_host(index, "cpu"), torch.from_numpy(sig),
        torch.from_numpy(slen), NormCarry(*(torch.from_numpy(c) for c in carry)),
        torch.from_numpy(ev_offset), torch.from_numpy(prev_key.astype(np.int64)),
        torch.from_numpy(prev_tpos), torch.from_numpy(prev_qpos),
        torch.from_numpy(n_prev), torch.from_numpy(active), **params,
    )
    scal = np.asarray(jout.scalars)
    np.testing.assert_array_equal(tout.scalars.numpy(), scal[:, :8])
    n_u = scal[:, 0]
    assert n_u[:2].min() > 0  # the rows made chains
    if k_cap == 2:
        assert scal[:, 6].max() > 0 and scal[:, 7].max() > 0  # both overflow
    summ = np.asarray(jout.summaries)
    for i in range(b):
        np.testing.assert_array_equal(tout.summaries.numpy()[i, :n_u[i]],
                                      summ[i, :n_u[i]])
    for a, c in ((tout.prev_key, jout.prev_key), (tout.prev_tpos, jout.prev_tpos),
                 (tout.prev_qpos, jout.prev_qpos), (tout.n_prev, jout.n_prev),
                 (tout.ev_offset, jout.ev_offset)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c).astype(a.numpy().dtype))
    for a, c in zip(tout.carry, jout.carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("tail_fixture")
    write_fixture(d)
    for preset in ("sensitive", "viral"):
        assert torch_cli.main(["-x", preset, "-p", str(d / "pore.model"), "-d",
                               str(d / f"{preset}.rhi.npz"), str(d / "ref.fa"),
                               "--device", "cpu"]) == 0
    return d


def _cols(path):
    return [line.split("\t")[:12] for line in path.read_text().splitlines()]


@pytest.mark.parametrize("preset", ["sensitive", "viral"])
def test_device_tail_paf_matches_host_tail_and_jax(fixture, monkeypatch, preset):
    d = fixture
    args = ["-x", preset, "--max-anchors", "512", str(d / f"{preset}.rhi.npz"),
            str(d / "reads.sig.npz")]
    monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
    assert torch_cli.main(args + ["--device", "cpu", "-o", str(d / "host.paf")]) == 0
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    assert torch_cli.main(args + ["--device", "cpu", "-o", str(d / "tail.paf")]) == 0
    assert jax_cli.main(args + ["-o", str(d / "jax_tail.paf")]) == 0
    tail = _cols(d / "tail.paf")
    assert tail == _cols(d / "host.paf")
    assert tail == _cols(d / "jax_tail.paf")
    assert sum(r[4] in "+-" for r in tail) >= 5


def test_device_tail_runs_the_backtrack(fixture, monkeypatch):
    """With the variable set the engine binds batches to the device tail and
    its profile (tracing on) holds the backtrack and compact stages; without
    it, the fixture's small widths stay on the host tail."""
    d = fixture
    index = load_index(str(d / "sensitive.rhi.npz"))
    reads = list(read_signals(str(d / "reads.sig.npz")))
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    eng = MappingEngine(index, options("sensitive")[1], device="cpu", trace=True)
    assert eng.device_tail
    eng.map_batch(reads)
    assert {"backtrack", "compact"} <= set(eng.profiler.totals)
    assert "host_tail" in eng.profiler.totals  # regions and decisions
    monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL")
    monkeypatch.setenv("RAWHASH_TPU_NO_DEVICE_TAIL", "1")
    eng = MappingEngine(index, options("sensitive")[1], device="cpu")
    assert not eng.device_tail and not eng._tail_auto
    monkeypatch.delenv("RAWHASH_TPU_NO_DEVICE_TAIL")
    eng = MappingEngine(index, options("sensitive")[1], device="cpu", trace=True)
    assert eng._tail_auto
    eng.map_batch(reads)
    assert not eng.device_tail and "backtrack" not in eng.profiler.totals


@pytest.mark.parametrize("preset", ["sensitive", "viral"])
def test_tail_switch_anchors_matches_jax(fixture, monkeypatch, preset):
    for var in ("RAWHASH_TPU_TAIL_SWITCH_ANCHORS", "RAWHASH_TPU_TAIL_SWITCH_BYTES",
                "RAWHASH_TPU_DEVICE_TAIL", "RAWHASH_TPU_NO_DEVICE_TAIL"):
        monkeypatch.delenv(var, raising=False)
    path = str(fixture / f"{preset}.rhi.npz")
    jmopt = jcfg.MapOptions()
    jcfg.set_preset(preset, jcfg.IndexOptions(), jmopt)
    want = JaxEngine(jax_load_index(path), jmopt).tail_switch_anchors
    eng = MappingEngine(load_index(path), options(preset)[1], device="cpu")
    assert eng.tail_switch_anchors == want


@pytest.mark.parametrize("env", [
    {"RAWHASH_TPU_TAIL_SWITCH_ANCHORS": "10"},
    {"RAWHASH_TPU_TAIL_SWITCH_ANCHORS": str(1 << 30)},
    {"RAWHASH_TPU_TAIL_SWITCH_BYTES": str(1 << 20)},
    {"RAWHASH_TPU_TAIL_SWITCH_BYTES": "1000"},  # under the floor of 512 anchors
    {"RAWHASH_TPU_TAIL_SWITCH_BYTES": str(1 << 30)},
    # a set watermark wins over a set budget; an empty one does not count
    {"RAWHASH_TPU_TAIL_SWITCH_ANCHORS": "77", "RAWHASH_TPU_TAIL_SWITCH_BYTES": "1000"},
    {"RAWHASH_TPU_TAIL_SWITCH_ANCHORS": "", "RAWHASH_TPU_TAIL_SWITCH_BYTES": str(1 << 22)},
])
def test_tail_switch_overrides_match_jax(fixture, monkeypatch, env):
    """With the JAX engine's overrides set, both engines switch tails at the
    same watermark, on the same index and options."""
    for var in ("RAWHASH_TPU_TAIL_SWITCH_ANCHORS", "RAWHASH_TPU_TAIL_SWITCH_BYTES",
                "RAWHASH_TPU_DEVICE_TAIL", "RAWHASH_TPU_NO_DEVICE_TAIL"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    path = str(fixture / "sensitive.rhi.npz")
    jmopt = jcfg.MapOptions()
    jcfg.set_preset("sensitive", jcfg.IndexOptions(), jmopt)
    want = JaxEngine(jax_load_index(path), jmopt).tail_switch_anchors
    eng = MappingEngine(load_index(path), options("sensitive")[1], device="cpu")
    assert eng.tail_switch_anchors == want
    default = 8 << 20
    if env.get("RAWHASH_TPU_TAIL_SWITCH_ANCHORS"):
        assert want == int(env["RAWHASH_TPU_TAIL_SWITCH_ANCHORS"])
    elif int(env["RAWHASH_TPU_TAIL_SWITCH_BYTES"]) != default:
        monkeypatch.delenv("RAWHASH_TPU_TAIL_SWITCH_BYTES")
        plain = MappingEngine(load_index(path), options("sensitive")[1], device="cpu")
        assert want != plain.tail_switch_anchors or want == 512


def _snap(res):
    return [(r.name, [(m.ref_id, m.frag_start, m.mapq, m.rev, m.mapped)
                      for m in r.records]) for r in res]


def test_auto_tail_switch_on_observed_width(monkeypatch):
    """The engine starts on the host tail and switches to the device tail
    once the observed anchor watermark crosses the threshold (here before
    chunk 0's anchor fetch); the records stay those of the host tail."""
    monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
    monkeypatch.delenv("RAWHASH_TPU_NO_DEVICE_TAIL", raising=False)
    index, mopt, reads = deployment(8000, "sensitive", 12, 600, 4096, seed=31)
    b1 = [(n, s) for n, s, _, _ in reads[:6]]
    b2 = [(n, s) for n, s, _, _ in reads[6:]]
    snap = _snap

    eng = MappingEngine(index, mopt, device="cpu")
    eng.tail_switch_anchors = 10
    assert not eng.device_tail and eng._tail_auto
    got1 = snap(eng.map_batch(b1))
    assert eng.device_tail, "watermark above threshold must flip the mode"
    got2 = snap(eng.map_batch(b2))  # mapped on the device tail

    eng2 = MappingEngine(index, mopt, device="cpu")
    eng2.tail_switch_anchors = 1 << 30
    want1 = snap(eng2.map_batch(b1))
    want2 = snap(eng2.map_batch(b2))
    assert not eng2.device_tail
    assert got1 == want1 and got2 == want2
    assert sum(m[-1] for _, recs in got1 + got2 for m in recs) >= 10


@pytest.mark.parametrize("case", ["chunk0_switch", "k_cap_regrow"])
def test_device_tail_reruns_only_what_grew(monkeypatch, case):
    """The chunk-0 switch finishes the step the host tail already ran, and a
    regrow of k_cap reruns only the backtrack and compaction: within a chunk
    the device step runs again only at a larger a_cap.  The records equal
    the host tail's."""
    from rawhash_tpu_torch.map import engine as eng_mod

    for var in ("RAWHASH_TPU_DEVICE_TAIL", "RAWHASH_TPU_NO_DEVICE_TAIL"):
        monkeypatch.delenv(var, raising=False)
    index, mopt, reads = deployment(8000, "sensitive", 6, 600, 4096, seed=31)
    batch = [(n, s) for n, s, _, _ in reads]
    ref = MappingEngine(index, mopt, device="cpu")
    ref.tail_switch_anchors = 1 << 30
    want = _snap(ref.map_batch(batch))

    chunks, tails = [], []  # a_cap of each step, per chunk; tail_finish calls
    for name, log in (("_submit_chunk", None), ("chunk_step", "a_cap"),
                      ("tail_finish", "k_cap")):
        fn = getattr(eng_mod, name)

        def spy(*a, _fn=fn, _log=log, **k):
            if _log is None:
                chunks.append([])
            elif _log == "a_cap":
                chunks[-1].append(k["a_cap"])
            else:
                tails.append(k["k_cap"])
            return _fn(*a, **k)
        monkeypatch.setattr(eng_mod, name, spy)

    if case == "k_cap_regrow":
        monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
        init = eng_mod._BatchState.__init__

        def narrow(self, *a, **k):
            init(self, *a, **k)
            self.k_cap = 1
        monkeypatch.setattr(eng_mod._BatchState, "__init__", narrow)
    eng = MappingEngine(index, mopt, device="cpu")
    if case == "chunk0_switch":
        eng.tail_switch_anchors = 10
    got = _snap(eng.map_batch(batch))
    assert got == want
    assert eng.stats["tail_chunks"] == len(chunks) > 0
    for caps in chunks:
        assert caps and all(a < b for a, b in zip(caps, caps[1:]))
    if case == "chunk0_switch":
        assert len(chunks[0]) == 1  # the host pass's step, not run again
    else:
        assert tails[0] == 1 and max(tails) > 1
        assert len(tails) > sum(map(len, chunks))  # tail reruns, step not
