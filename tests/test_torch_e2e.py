"""The port end to end on the CPU: its CLI against the reference CLI on the
same fixture (PAF columns 1-12), capacity growth without truncation, index
files shared by both packages, and proof that the port imports neither jax
nor the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu.index import ref_ind as jax_ref_ind  # noqa: E402
from rawhash_tpu.index import serialize as jax_serialize  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.index import ref_ind, serialize  # noqa: E402
from rawhash_tpu_torch.index.serialize import load_index  # noqa: E402
from rawhash_tpu_torch.io.sigfile import read_signals  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine, unsupported_options  # noqa: E402
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


@pytest.mark.filterwarnings(
    "ignore:`torch.distributed.(all_gather_into_tensor|reduce_scatter_tensor)`"
    ":FutureWarning")
def test_n_shards_one_matches_the_unsharded_run(fixture):
    """--n-shards 1 on the CPU (a world of one, gloo) gives the unsharded
    run's PAF columns 1-12; the engine refuses no option."""
    d, _ = fixture
    args = ["-x", "sensitive", "--max-anchors", "512", "--device", "cpu",
            str(d / "sensitive.rhi.npz"), str(d / "reads.sig.npz")]
    assert torch_cli.main(args + ["-o", str(d / "plain.paf")]) == 0
    assert torch_cli.main(args + ["--n-shards", "1", "-o", str(d / "shards.paf")]) == 0
    plain, sharded = _paf(d / "plain.paf"), _paf(d / "shards.paf")
    assert [r[:12] for r in sharded] == [r[:12] for r in plain]
    assert sum(r[4] in "+-" for r in plain) >= 5
    mopt = options("sensitive")[1]
    mopt.n_shards = 4
    assert unsupported_options(mopt) == []


def test_out_quantize_matches_reference(fixture):
    """--out-quantize prints each read's quantized event stream: the same
    text as the reference CLI's."""
    d, _ = fixture
    args = ["-x", "sensitive", "--out-quantize", str(d / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(d / "jax.oq")]) == 0
    assert torch_cli.main(args + ["--device", "cpu", "-o", str(d / "torch.oq")]) == 0
    text = (d / "torch.oq").read_text()
    assert text == (d / "jax.oq").read_text()
    assert len(text.splitlines()) == 12


def test_cli_runs_without_jax(fixture):
    """`python -m rawhash_tpu_torch --device cpu` maps the fixture with jax
    and the JAX package made unimportable, and neither is loaded
    afterwards: the default mapping, all-vs-all (index built from the reads
    with --sig-target) and DTW chain evaluation (a --store-sig index)."""
    d, _ = fixture
    code = (
        "import json, sys, runpy\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "sys.modules['rawhash_tpu'] = None  # and of the JAX package\n"
        "for argv in json.loads(sys.argv[1]):\n"
        "    sys.argv = ['rawhash_tpu_torch'] + argv\n"
        "    try:\n"
        "        runpy.run_module('rawhash_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and (\n"
        "          m in ('jax', 'rawhash_tpu') or m.startswith(('jax.', 'rawhash_tpu.')))]\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK', file=sys.stderr)\n"
    )
    reads, cpu = str(d / "reads.sig.npz"), ["--device", "cpu"]
    runs = [
        ["-x", "sensitive", "--max-anchors", "512", *cpu,
         str(d / "sensitive.rhi.npz"), reads, "-o", str(d / "nojax.paf")],
        ["-x", "ava", "--sig-target", "-d", str(d / "nojax_ava.rhi.npz"), reads, *cpu],
        ["-x", "ava", *cpu, str(d / "nojax_ava.rhi.npz"), reads,
         "-o", str(d / "nojax_ava.paf")],
        ["-x", "sensitive", "-p", str(d / "pore.model"), "--store-sig", "-d",
         str(d / "nojax_sig.rhi.npz"), str(d / "ref.fa"), *cpu],
        ["-x", "sensitive", "--dtw-evaluate-chains", "--max-anchors", "512", *cpu,
         str(d / "nojax_sig.rhi.npz"), reads, "-o", str(d / "nojax_dtw.paf")],
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(runs)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stderr
    for paf, n_mapped in (("nojax.paf", 5), ("nojax_ava.paf", 0), ("nojax_dtw.paf", 5)):
        lines = [l.split("\t") for l in (d / paf).read_text().splitlines()]
        assert len(lines) == 6 and sum(l[4] in "+-" for l in lines) >= n_mapped, paf
        assert np.all([len(l) >= 13 for l in lines])


def _imports(path: Path):
    """Every module a Python file imports, lazily or not (relative imports
    resolved against the package)."""
    rel = path.relative_to(REPO).with_suffix("")
    pkg = list(rel.parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


@pytest.mark.parametrize("where", ["rawhash_tpu_torch", "chip_smoke.py"])
def test_port_imports_nothing_of_jax_or_the_jax_package(where):
    files = ([REPO / where] if where.endswith(".py")
             else sorted((REPO / where).rglob("*.py")))
    assert len(files) > 10 or where.endswith(".py")
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "rawhash_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("fmt", ["rhi", "ind"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_index_files_interchange(fixture, tmp_path, fmt, writer):
    """An index written by either package loads in the other, unchanged."""
    d, _ = fixture
    src = load_index(str(d / "sensitive.rhi.npz"))
    path = str(tmp_path / f"x.{'rhi.npz' if fmt == 'rhi' else 'ind'}")
    if writer == "torch":
        (serialize.save_index if fmt == "rhi" else ref_ind.dump_ref_index)(path, src)
        got = (jax_serialize.load_index if fmt == "rhi"
               else jax_ref_ind.load_ref_index)(path)
    else:
        jsrc = jax_serialize.load_index(str(d / "sensitive.rhi.npz"))
        (jax_serialize.save_index if fmt == "rhi"
         else jax_ref_ind.dump_ref_index)(path, jsrc)
        got = (serialize.load_index if fmt == "rhi" else ref_ind.load_ref_index)(path)
    for name in ("keys", "offsets", "pos", "seq_lens"):
        np.testing.assert_array_equal(getattr(got, name), getattr(src, name))
    assert list(got.seq_names) == list(src.seq_names)
    assert (got.opts.k, got.opts.e, got.opts.q, got.opts.w) == (
        src.opts.k, src.opts.e, src.opts.q, src.opts.w)
