"""The port end to end on the CPU: its CLI against the reference CLI on the
same fixture (PAF columns 1-12), capacity growth without truncation, and a
run that proves the port never imports jax."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu.index.serialize import load_index  # noqa: E402
from rawhash_tpu.io.sigfile import read_signals  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine  # noqa: E402
from rawhash_tpu_torch.synthetic import options, write_fixture  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    truth = write_fixture(d)
    for preset in ("sensitive", "viral"):
        assert jax_cli.main(["-x", preset, "-p", str(d / "pore.model"), "-d",
                             str(d / f"{preset}.rhi.npz"), str(d / "ref.fa")]) == 0
    return d, truth


def _paf(path):
    return [line.split("\t") for line in Path(path).read_text().splitlines()]


@pytest.mark.parametrize("preset", ["sensitive", "viral"])
def test_paf_matches_reference(fixture, preset):
    d, truth = fixture
    args = ["-x", preset, "--max-anchors", "512", str(d / f"{preset}.rhi.npz"),
            str(d / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(d / f"jax_{preset}.paf")]) == 0
    assert torch_cli.main(args + ["--device", "cpu",
                                  "-o", str(d / f"torch_{preset}.paf")]) == 0
    ref = _paf(d / f"jax_{preset}.paf")
    got = _paf(d / f"torch_{preset}.paf")
    assert [r[:12] for r in got] == [r[:12] for r in ref]
    mapped = [r for r in got if r[4] in "+-"]
    assert len(mapped) >= 5
    for r in mapped:  # and the mappings are right
        start, strand = truth[r[0]]
        assert r[4] == "+-"[strand]
        assert start - 200 <= int(r[7]) and int(r[8]) <= start + 600 + 200


def test_capacity_growth_drops_nothing(fixture):
    """A tiny initial anchor capacity regrows (quarantine sub-batches) to
    exactly the mappings of a roomy one."""
    d, _ = fixture
    index = load_index(str(d / "sensitive.rhi.npz"))
    reads = list(read_signals(str(d / "reads.sig.npz")))
    recs = {}
    for cap in (64, 4096):
        mopt = options("sensitive")[1]
        mopt.max_anchors_per_read = cap
        engine = MappingEngine(index, mopt, device="cpu")
        res = engine.map_batch(reads)
        recs[cap] = [[(m.mapped, m.ref_id, m.rev, m.frag_start, m.frag_len,
                       m.mapq, m.read_start, m.read_end) for m in r.records]
                     for r in res]
        if cap == 64:
            assert engine.stats["anchor_regrows"] > 0
        assert engine.stats["hit_overflow"] == 0
    assert recs[64] == recs[4096]


def test_unsupported_modes_are_refused(fixture):
    d, _ = fixture
    rc = torch_cli.main(["-x", "sensitive", "--rmq", "--device", "cpu",
                         str(d / "sensitive.rhi.npz"), str(d / "reads.sig.npz")])
    assert rc == 1


def test_cli_runs_without_jax(fixture):
    """`python -m rawhash_tpu_torch --device cpu` maps the fixture with jax
    made unimportable, and no jax module is loaded afterwards."""
    d, _ = fixture
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "sys.argv = ['rawhash_tpu_torch'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('rawhash_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = [m for m, v in sys.modules.items()\n"
        "          if v is not None and (m == 'jax' or m.startswith('jax.'))]\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK', file=sys.stderr)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, "-x", "sensitive", "--max-anchors", "512",
         "--device", "cpu", str(d / "sensitive.rhi.npz"), str(d / "reads.sig.npz")],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stderr
    lines = [l.split("\t") for l in proc.stdout.splitlines()]
    assert len(lines) == 6 and sum(l[4] in "+-" for l in lines) >= 5
    assert np.all([len(l) >= 13 for l in lines])
