"""RMQ chaining (--rmq) and long-gap re-chaining (--bw-long) in the port
against the JAX package: lchain_rmq_np bit for bit (native and numpy
paths), and the CLI's PAF columns 1-12 on the fixture."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu.chain.rmq import lchain_rmq_np as jax_rmq  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.chain.rmq import lchain_rmq_np  # noqa: E402
from rawhash_tpu_torch.synthetic import write_fixture  # noqa: E402


def _anchors(seed: int, n: int = 400):
    """Packed anchors (x = rev<<63 | tid<<32 | tpos, y = span<<32 | qpos)
    sorted by x: a true diagonal per strand plus repeat-dense noise over
    two targets."""
    rng = np.random.default_rng(seed)
    n_true = n // 4
    tpos = np.concatenate([np.arange(n_true) * 7 + rng.integers(0, 3, n_true),
                           rng.integers(0, 4, n - n_true) * 200
                           + rng.integers(0, 250, n - n_true)])
    qpos = np.concatenate([np.arange(n_true) * 3, rng.integers(0, 800, n - n_true)])
    tid = np.concatenate([np.zeros(n_true, np.int64), rng.integers(0, 2, n - n_true)])
    rev = rng.integers(0, 2, n)
    ax = ((rev.astype(np.uint64) << np.uint64(63)) | (tid.astype(np.uint64) << np.uint64(32))
          | tpos.astype(np.uint64))
    ay = (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)
    order = np.argsort(ax, kind="stable")
    return ax[order], ay[order]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("bw,cap", [(500, 100000), (2500, 100000), (500, 24)])
def test_lchain_rmq_matches_jax(monkeypatch, native, bw, cap):
    """Chains, chain anchors and carried anchors equal JAX's bit for bit,
    through the native fill and through the numpy oracle."""
    if not native:
        monkeypatch.setenv("RAWHASH_TPU_NO_NATIVE_RMQ", "1")
    for seed in range(3):
        ax, ay = _anchors(seed)
        args = (ax, ay, 2500, 1000, bw, 5, cap, 2, 15, 0.104, 0.01)
        got, want = lchain_rmq_np(*args), jax_rmq(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] >= 1


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("rmq_fixture")
    write_fixture(d)
    assert torch_cli.main(["-x", "sensitive", "-p", str(d / "pore.model"), "-d",
                           str(d / "sensitive.rhi.npz"), str(d / "ref.fa"),
                           "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("mode", [["--rmq"], ["--bw-long", "2500"]])
def test_rmq_cli_matches_jax(fixture, mode):
    """--rmq (RMQ chaining in place of the DP's backtrack) and --bw-long
    (an RMQ re-chaining pass at 5x the preset's --bw): PAF columns 1-12
    equal JAX's, every read mapped."""
    d = fixture
    args = ["-x", "sensitive", *mode, "--max-anchors", "512",
            str(d / "sensitive.rhi.npz"), str(d / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(d / "jax.paf")]) == 0
    assert torch_cli.main(args + ["--device", "cpu", "-o", str(d / "torch.paf")]) == 0
    cols = [[line.split("\t")[:12] for line in Path(d / f).read_text().splitlines()]
            for f in ("jax.paf", "torch.paf")]
    assert cols[0] == cols[1]
    assert sum(r[4] in "+-" for r in cols[1]) == 6
