"""Sequence Until in the port against the JAX package: the same stopping
decisions on one observation stream, and the CLI stops at the same read
with the same PAF columns 1-12."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu.map.sequence_until import SequenceUntil as JaxSequenceUntil  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.map.sequence_until import SequenceUntil  # noqa: E402
from rawhash_tpu_torch.synthetic import write_fixture  # noqa: E402


@pytest.mark.parametrize("params", [(3, 0.01, 3, 10, 20), (2, 1e-9, 3, 5, 5),
                                    (4, 0.05, 5, 7, 30)])
def test_sequence_until_decisions_match_jax(params):
    """One stream of (target, fragment length) observations, drawn from a
    seed with drifting abundances: every observe() answers as JAX's does,
    and the estimates agree at the end."""
    n_seq = params[0]
    rng = np.random.default_rng(n_seq)
    su, jsu = SequenceUntil(*params), JaxSequenceUntil(*params)
    stops = []
    for i in range(600):
        p = np.linspace(1.0, 2.0 + i / 300, n_seq)
        ref = int(rng.choice(n_seq, p=p / p.sum()))
        length = int(rng.integers(500, 5000))
        got, want = su.observe(ref, length), jsu.observe(ref, length)
        assert got == want, i
        stops.append(got)
    np.testing.assert_array_equal(su.abundances(), jsu.abundances())
    assert su.nreads == jsu.nreads and su.nestimations == jsu.nestimations
    if params[1] > 1e-6:
        assert any(stops)  # these thresholds converge within the stream


def test_sequence_until_cli_stops_at_the_same_read(tmp_path):
    """On the fixture, with estimates tested after every mapped read from
    the second on, both CLIs stop after the same read (two reads a batch,
    so later batches are never read) with the same PAF columns 1-12."""
    write_fixture(tmp_path)
    idx = str(tmp_path / "sensitive.rhi.npz")
    assert torch_cli.main(["-x", "sensitive", "-p", str(tmp_path / "pore.model"),
                           "-d", idx, str(tmp_path / "ref.fa"), "--device", "cpu"]) == 0
    args = ["-x", "sequence-until", "--sequence-until", "--min-reads", "1",
            "--test-frequency", "1", "--n-samples", "2", "--batch-reads", "2",
            "--max-anchors", "512", idx, str(tmp_path / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax.paf")]) == 0
    assert torch_cli.main(args + ["--device", "cpu",
                                  "-o", str(tmp_path / "torch.paf")]) == 0
    cols = [[line.split("\t")[:12] for line in Path(tmp_path / f).read_text().splitlines()]
            for f in ("jax.paf", "torch.paf")]
    assert cols[0] == cols[1]
    assert 0 < len(cols[1]) < 6  # stopped before the last read
