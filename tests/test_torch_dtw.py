"""DTW chain evaluation in the port against the JAX package: the banded
batch DTW (plain PyTorch, on the CPU here), its prefix sum in XLA's order,
the batched chain evaluation, and the CLI with --dtw-evaluate-chains on a
--store-sig index (PAF columns 1-12)."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu.chain.regions import Region as JaxRegion  # noqa: E402
from rawhash_tpu.config import DtwBorderConstraint as JaxBorder  # noqa: E402
from rawhash_tpu.config import MapOptions as JaxMapOptions  # noqa: E402
from rawhash_tpu.dtw.device import dtw_banded_batch_host as jax_dtw  # noqa: E402
from rawhash_tpu.dtw.evaluate import evaluate_chains_batched as jax_evaluate  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.chain.regions import Region  # noqa: E402
from rawhash_tpu_torch.config import DtwBorderConstraint, MapOptions  # noqa: E402
from rawhash_tpu_torch.dtw import device as tdtw  # noqa: E402
from rawhash_tpu_torch.dtw.evaluate import evaluate_chains_batched  # noqa: E402
from rawhash_tpu_torch.synthetic import write_fixture  # noqa: E402


def test_cumsum_adds_in_xlas_order():
    """The band's prefix sum equals jnp.cumsum bit for bit at every width a
    band takes (sequential up to 16, blocked past it, nested past 256);
    torch.cumsum does not."""
    rng = np.random.default_rng(3)
    cumsum = jax.jit(lambda x: jnp.cumsum(x, axis=1))
    differs = 0
    for n in (1, 2, 9, 16, 17, 33, 64, 129, 257, 300, 1025):
        x = (rng.random((8, n)) * 100).astype(np.float32)
        want = np.asarray(cumsum(jnp.asarray(x)))
        np.testing.assert_array_equal(tdtw._cumsum(torch.from_numpy(x)).numpy(), want)
        differs += not np.array_equal(torch.cumsum(torch.from_numpy(x), 1).numpy(), want)
    assert differs > 0


def _pairs(rng, n, lo=12, hi=61):
    return [(rng.normal(0, 1, int(rng.integers(lo, hi))).astype(np.float32),
             rng.normal(0, 1, int(rng.integers(lo, hi))).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("radius", [1, 4, 9, 16, "per_pair"])
def test_dtw_banded_batch_matches_jax(radius):
    """Random pairs of 12-60 events plus one of 512 against 500, one radius
    for all or one per pair (1-16): costs within 1e-4 relative of JAX's,
    and in fact bit-equal."""
    rng = np.random.default_rng(7 if radius == "per_pair" else radius)
    pairs = _pairs(rng, 24)
    pairs.append((rng.normal(0, 1, 512).astype(np.float32),
                  rng.normal(0, 1, 500).astype(np.float32)))
    r = rng.integers(1, 17, len(pairs)) if radius == "per_pair" else radius
    want = jax_dtw(pairs, r)
    got = tdtw.dtw_banded_batch_host(pairs, r, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_array_equal(got, want)


def _jobs(region_cls, seed):
    """Three reads' chains over one target's stored signal, as the JAX DTW
    test makes them, built with `region_cls`: (index, jobs)."""
    rng = np.random.default_rng(seed)

    class Index:
        F = [rng.normal(0, 1, 800).astype(np.float32)]
        R = [rng.normal(0, 1, 800).astype(np.float32)]

    read_events = rng.normal(0, 1, 400).astype(np.float32)
    jobs = []
    for _ in range(3):
        regs, bx, by, as_ = [], [], [], 0
        for _ in range(int(rng.integers(1, 4))):
            cnt = int(rng.integers(2, 7))
            tp = np.sort(rng.integers(0, 700, cnt)).astype(np.uint64)
            qp = np.sort(rng.integers(0, 350, cnt)).astype(np.uint64)
            bx.append(tp)
            by.append(qp)
            regs.append(region_cls(rid=0, rev=int(rng.integers(0, 2)),
                                   rs=int(tp[0]), re=int(tp[-1]),
                                   qs=int(qp[0]), qe=int(qp[-1]),
                                   score=50, cnt=cnt, as_=as_))
            as_ += cnt
        jobs.append((regs, np.concatenate(bx), np.concatenate(by), read_events))
    return Index, jobs


@pytest.mark.parametrize("border", ["sparse", "global"])
@pytest.mark.parametrize("seed", [31, 32])
def test_evaluate_chains_batched_matches_jax(border, seed):
    """The same chains give the same alignment scores (early termination
    and clamping included)."""
    mo, jmo = MapOptions(), JaxMapOptions()
    if border == "global":
        mo.dtw_border_constraint = DtwBorderConstraint.GLOBAL
        jmo.dtw_border_constraint = JaxBorder.GLOBAL
    index, jobs = _jobs(Region, seed)
    jindex, jjobs = _jobs(JaxRegion, seed)
    evaluate_chains_batched(jobs, index, mo, device="cpu")
    jax_evaluate(jjobs, jindex, jmo)
    got = [r.alignment_score for regs, *_ in jobs for r in regs]
    want = [r.alignment_score for regs, *_ in jjobs for r in regs]
    assert got == want
    assert len(got) >= 3


@pytest.mark.parametrize("preset", ["sensitive", "viral"])
def test_dtw_cli_matches_jax(tmp_path, preset):
    """--dtw-evaluate-chains on a --store-sig index of the fixture: PAF
    columns 1-12 (MAPQ from the alignment scores included) equal JAX's."""
    write_fixture(tmp_path)
    idx = str(tmp_path / "sig.rhi.npz")
    assert torch_cli.main(["-x", preset, "-p", str(tmp_path / "pore.model"),
                           "--store-sig", "-d", idx, str(tmp_path / "ref.fa"),
                           "--device", "cpu"]) == 0
    args = ["-x", preset, "--dtw-evaluate-chains", "--max-anchors", "512", idx,
            str(tmp_path / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax.paf")]) == 0
    assert torch_cli.main(args + ["--device", "cpu",
                                  "-o", str(tmp_path / "torch.paf")]) == 0
    cols = [[line.split("\t")[:12] for line in Path(tmp_path / f).read_text().splitlines()]
            for f in ("jax.paf", "torch.paf")]
    assert cols[0] == cols[1]
    assert sum(r[4] in "+-" for r in cols[1]) >= 5
