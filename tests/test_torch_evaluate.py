"""The port's copy of the PAF evaluator (rawhash_tpu_torch/evaluate.py)
against the JAX package's module: on the same PAF text both return the same
classification, throughput statistics, annotated lines and location
agreement."""

import numpy as np
import pytest

from rawhash_tpu import evaluate as jax_eval
from rawhash_tpu_torch import evaluate as port_eval


def _pafs(seed: int):
    """A tool PAF and a truth PAF of 40 reads over 3 targets from a seed:
    reads mapped or not by either, the tool's target and interval sometimes
    off, some reads with a second record, tags mt:f and sl:i on the tool's
    lines (a few without), and a short line the parser skips."""
    rng = np.random.default_rng(seed)
    tool, truth = [], []
    for i in range(40):
        name, qlen = f"read_{i:03d}", int(rng.integers(300, 5000))
        t_mapped = rng.random() < 0.8
        t_target = f"chr{rng.integers(1, 4)}"
        t_start = int(rng.integers(0, 100_000))
        if t_mapped:
            truth.append(f"{name}\t{qlen}\t0\t{qlen}\t+\t{t_target}\t200000"
                         f"\t{t_start}\t{t_start + qlen}\t{qlen}\t{qlen}\t60")
        else:
            truth.append(f"{name}\t{qlen}\t*\t*\t*\t*\t*\t*\t*\t*\t*\t255")
        for rec in range(1 + (rng.random() < 0.1)):
            tags = "" if rng.random() < 0.1 else (
                f"\tmt:f:{rng.uniform(0.0, 50.0):.6f}\tci:i:2"
                f"\tsl:i:{int(rng.integers(1000, 40000))}")
            if rng.random() < 0.75:
                target = t_target if rng.random() < 0.85 else f"chr{rng.integers(1, 4)}"
                start = t_start + int(rng.integers(-400, 400))
                tool.append(f"{name}\t{qlen}\t0\t{qlen}\t{'+-'[rec]}\t{target}"
                            f"\t200000\t{max(start, 0)}\t{max(start, 0) + qlen}"
                            f"\t{qlen}\t{qlen}\t{int(rng.integers(0, 61))}{tags}")
            else:
                tool.append(f"{name}\t{qlen}\t*\t*\t*\t*\t*\t*\t*\t*\t*\t255{tags}")
    tool.insert(7, "truncated\tline")
    return tool, truth


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_evaluate_matches_jax(seed):
    tool, truth = _pafs(seed)
    got = port_eval.evaluate_paf(tool, truth)
    want = jax_eval.evaluate_paf(tool, truth)
    assert got.as_dict() == want.as_dict()
    assert got.annotations == want.annotations
    assert got.tp + got.fp > 0 and got.fn + got.tn > 0
    assert list(port_eval.annotate_paf(tool, truth)) == list(
        jax_eval.annotate_paf(tool, truth))
    for slop in (0, 150):
        assert (port_eval.location_overlap(tool, truth, slop)
                == jax_eval.location_overlap(tool, truth, slop))


def test_evaluate_reads_files_as_jax(tmp_path):
    """From PAF files on disk: the same parsed records and the same dict."""
    tool, truth = _pafs(4)
    (tmp_path / "tool.paf").write_text("\n".join(tool) + "\n")
    (tmp_path / "truth.paf").write_text("\n".join(truth) + "\n")
    paths = (str(tmp_path / "tool.paf"), str(tmp_path / "truth.paf"))
    got = port_eval.parse_paf(paths[0])
    want = jax_eval.parse_paf(paths[0])
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert len(got) == len(tool) - 1  # the short line is skipped
    assert (port_eval.evaluate_paf(*paths).as_dict()
            == jax_eval.evaluate_paf(*paths).as_dict())
