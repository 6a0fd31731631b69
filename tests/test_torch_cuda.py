"""The CUDA kernels on a card, against their plain PyTorch versions.

These need an NVIDIA GPU and skip without one.  They import no jax, so on a
machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch.chain.backtrack import (  # noqa: E402
    DEPTH, MAX_WIDTH, SMEM_MAX, backtrack_launch, candidate_order,
    chain_backtrack, launch_depth, shared_bytes,
)
from rawhash_tpu_torch.chain.backtrack_device import backtrack_plain  # noqa: E402
from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.chain.fill import MAX_ITER_CAP, chain_fill  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.profiling.bounds import fill_work  # noqa: E402
from rawhash_tpu_torch.profiling.fill_loop_overhead import (  # noqa: E402
    INT32_MIN, MAX_W, fill_loop_probe, fill_loop_probe_plain,
)
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    ava_fixture_reads, border_anchors, clustered_anchors, options, random_chains,
    sparse_anchors, wide_band_anchors,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["viral", "sensitive"])
@pytest.mark.parametrize("b,n", [(3, 100), (64, 2048)])
def test_chain_fill_kernel_matches_plain(cuda_device, preset, b, n):
    rng = np.random.default_rng(n)
    tpos = np.sort(rng.integers(0, 4 * n, (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 2 + rng.integers(-20, 20, (b, n))).clip(0).astype(np.int32)
    key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
    n_anchors = rng.integers(0, n + 1, b).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (key.view(np.int32), tpos, qpos, n_anchors)]
    prm = fill_params(*options(preset))
    assert fill_work(*args, **prm)["unsorted"] == 0  # the kernel's precondition
    before = chain_fill.launches
    f, p = chain_fill(*args, **prm)
    f0, p0 = chain_fill_batch(*args, **prm)
    torch.cuda.synchronize()
    assert chain_fill.launches == before + 1
    assert torch.equal(f, f0) and torch.equal(p, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["viral", "sensitive"])
@pytest.mark.parametrize("inputs,w", [("sparse", 200), ("clustered", 845),
                                      ("borders", 1),
                                      ("borders", 16), ("borders", 200),
                                      ("borders", 845), ("borders", MAX_ITER_CAP)])
def test_chain_fill_kernel_matches_plain_on_segments(cuda_device, preset, inputs, w):
    """Rows of many chain segments: lone hits with a few clusters (D4-like),
    segments of 500-1000 anchors (clustered, some longer than W), and tpos gaps
    of exactly the band's end and one more, duplicate tpos, a strand change
    at the last live anchor, 0 and 1 live anchors; W up to
    the ring's cap (16 warps a read up to W = 844, 15 at 845, one warp's
    ring in the block's whole shared memory at the cap)."""
    prm = dict(fill_params(*options(preset)), max_iter=w)
    a = {"sparse": lambda: sparse_anchors(7, 64, 3000),
         "clustered": lambda: clustered_anchors(2048, 8, 2048),
         "borders": lambda: border_anchors(prm["max_dist_t"], prm["bw"], n=700),
         }[inputs]()
    args = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(cuda_device)
            if x.dtype == np.uint32 else torch.from_numpy(x).to(cuda_device)
            for x in a]
    assert fill_work(*args, **prm)["unsorted"] == 0  # the kernel's precondition
    f, p = chain_fill(*args, **prm)
    f0, p0 = chain_fill_batch(*args, **prm)
    torch.cuda.synchronize()
    assert torch.equal(f, f0) and torch.equal(p, p0)
    assert int((p >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["viral", "sensitive"])
@pytest.mark.parametrize("w", [MAX_ITER_CAP + 1, 20000])
def test_chain_fill_kernel_past_the_shared_memory_cap(cuda_device, preset, w):
    """W past one ring's shared memory: the rings in global scratch, bit
    for bit against the plain fill, on rows whose every predecessor is in
    band and whose chains step MAX_ITER_CAP + 1 anchors back, out of reach
    of the shared-memory path's widest window."""
    prm = dict(fill_params(*options(preset)), max_iter=w)
    a = wide_band_anchors(11, 2, 16384, 100, MAX_ITER_CAP + 1)
    args = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(cuda_device)
            for x in a]
    before = chain_fill.launches
    f, p = chain_fill(*args, **prm)
    f0, p0 = chain_fill_batch(*args, **prm)
    f_cap, _ = chain_fill(*args, **dict(prm, max_iter=MAX_ITER_CAP))
    torch.cuda.synchronize()
    assert chain_fill.launches == before + 2
    assert torch.equal(f, f0) and torch.equal(p, p0)
    assert (f > f_cap).any()


@pytest.mark.cuda
def test_chain_fill_rejects_wrong_dtype(cuda_device):
    x = torch.zeros((2, 8), dtype=torch.int64, device=cuda_device)
    n = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        chain_fill(x, x, x, n, **fill_params(*options("viral")))


BT = dict(min_cnt=2, min_sc=20, max_drop=500, q_span=13)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k_cap", [(256, 64), (33024, 64), (33024, 4)])
def test_chain_backtrack_kernel_matches_plain(cuda_device, n, k_cap):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in random_chains(n, 8, n, min(120, n // 4))]
    before = chain_backtrack.launches
    got = chain_backtrack(*args, **BT, k_cap=k_cap)
    want = backtrack_plain(*args, **BT, k_cap=k_cap)
    torch.cuda.synchronize()
    assert chain_backtrack.launches == before + 1
    assert chain_backtrack.max_width >= n
    for a, c in zip(want, got):
        assert torch.equal(a, c)
    assert int(got[2].min()) > 0
    if k_cap < 10:
        assert int(got[5].min()) > 0


def staging_threshold() -> int:
    """The most live anchors a row may have for the claimed bits and the
    staging buffer of the default depth to fit in shared memory."""
    a = (SMEM_MAX - shared_bytes(1, DEPTH) + 4) // 4 * 32
    assert shared_bytes(a, DEPTH) <= SMEM_MAX < shared_bytes(a + 1, DEPTH)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["below", "at", "above", "max_width"])
def test_chain_backtrack_kernel_at_the_staging_threshold(cuda_device, side):
    """Rows whose most live anchors leave the staging buffer of the default
    depth room (below the threshold, at it), or less (one past it: a
    shallower depth; MAX_WIDTH: depth 0, no walk staged)."""
    thr = staging_threshold()
    a = {"below": thr - 50000, "at": thr, "above": thr + 1,
         "max_width": MAX_WIDTH}[side]
    args = [torch.from_numpy(x).to(cuda_device)
            for x in random_chains(a % 1000, 2, a, 120)]
    args[2] = torch.tensor([a, a - 7], dtype=torch.int32, device=cuda_device)
    depth = launch_depth(a)
    assert (depth == DEPTH) == (side in ("below", "at"))
    assert (depth == 0) == (side == "max_width")
    before = chain_backtrack.launches
    got = chain_backtrack(*args, **BT, k_cap=256)
    want = backtrack_plain(*args, **BT, k_cap=256)
    torch.cuda.synchronize()
    assert chain_backtrack.launches == before + 1
    for x, y in zip(want, got):
        assert torch.equal(x, y)
    assert int(got[2].min()) > 0 and int(got[9].max()) > a - 1200


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2, 8, 16, 32])
def test_chain_backtrack_kernel_depths_match_plain(cuda_device, depth):
    """The kernel at each staging depth on clustered rows (long walks,
    paths shared inside a round) from the fill kernel."""
    prm = fill_params(*options("sensitive"))
    key, tpos, qpos, n_anchors = (torch.from_numpy(x).to(cuda_device)
                                  for x in clustered_anchors(3, 8, 4096))
    f, p = chain_fill(key, tpos, qpos, n_anchors, **prm)
    bt = dict(BT, min_sc=15)
    order = candidate_order(f, n_anchors, bt["min_sc"])
    before = chain_backtrack.launches
    got = backtrack_launch(f, p, tpos, qpos, order, **bt, k_cap=1024, depth=depth)
    want = backtrack_plain(f, p, n_anchors, tpos, qpos, **bt, k_cap=1024)
    torch.cuda.synchronize()
    assert chain_backtrack.launches == before  # variants are not counted
    for x, y in zip(want, got):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_chain_backtrack_rejects_wrong_dtype_or_device(cuda_device):
    f, p, n_anchors, tpos, qpos = (torch.from_numpy(x).to(cuda_device)
                                   for x in random_chains(1, 2, 64, 8))
    with pytest.raises(ValueError):
        chain_backtrack(f.long(), p, n_anchors, tpos, qpos, **BT, k_cap=8)
    with pytest.raises(ValueError):
        chain_backtrack(f, p.cpu(), n_anchors, tpos, qpos, **BT, k_cap=8)
    with pytest.raises(ValueError):
        chain_backtrack(f, p, n_anchors, tpos, qpos, **BT, k_cap=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k_ops", [2, 60])
@pytest.mark.parametrize("w", [64, 200])
def test_fill_loop_probe_kernel_matches_plain(cuda_device, w, k_ops):
    x = torch.from_numpy(np.random.default_rng(w + k_ops).integers(
        -2**20, 2**20, (w, 256)).astype(np.int32)).to(cuda_device)
    before = fill_loop_probe.launches
    got = fill_loop_probe(x, 1000, k_ops)
    want = fill_loop_probe_plain(x, 1000, k_ops)
    torch.cuda.synchronize()
    assert fill_loop_probe.launches == before + 1
    assert torch.equal(got, want)
    start = torch.full_like(x, INT32_MIN)
    assert torch.equal(fill_loop_probe(start, 1000, k_ops),
                       torch.full_like(x, INT32_MIN + 1000 * k_ops))


@pytest.mark.cuda
def test_fill_loop_probe_rejects_wrong_input(cuda_device):
    for bad in (torch.zeros((64, 256), dtype=torch.int64, device=cuda_device),
                torch.zeros((256, 64), dtype=torch.int32, device=cuda_device).t(),
                torch.zeros(64, dtype=torch.int32, device=cuda_device),
                torch.zeros((MAX_W + 1, 2), dtype=torch.int32, device=cuda_device)):
        with pytest.raises(ValueError):
            fill_loop_probe(bad, 10, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["host", "device"])
def test_ava_fixture_on_the_card_matches_cpu(cuda_device, monkeypatch, tail):
    """All-vs-all on the card: the same records as on the CPU, through the
    fill kernel (and the backtrack kernel on the device tail)."""
    from rawhash_tpu_torch.index.build import build_index_from_signals
    from rawhash_tpu_torch.map.engine import MappingEngine

    if tail == "device":
        monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    else:
        monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
    reads = ava_fixture_reads()
    io, mo = options("ava-viral")
    mo.max_anchors_per_read = 512
    index = build_index_from_signals(reads, None, io)
    recs = {}
    fills, backtracks = chain_fill.launches, chain_backtrack.launches
    for dev in (cuda_device, "cpu"):
        res = MappingEngine(index, mo, device=dev).map_batch(reads)
        recs[str(dev)] = [(r.name, [(m.ref_id, m.read_start, m.read_end, m.frag_start,
                                     m.frag_len, m.mapq, m.rev, m.mapped)
                                    for m in r.records]) for r in res]
    assert recs["cuda"] == recs["cpu"]
    assert sum(m[-1] for _, rs in recs["cpu"] for m in rs) >= 3
    assert chain_fill.launches > fills
    assert (chain_backtrack.launches > backtracks) == (tail == "device")


@pytest.mark.cuda
def test_dtw_banded_batch_on_the_card_matches_cpu(cuda_device):
    """The plain PyTorch banded DTW on the card against its CPU run: pairs
    of 12-60 events plus one of 512, per-pair radii 1-16."""
    from rawhash_tpu_torch.dtw.device import dtw_banded_batch_host

    rng = np.random.default_rng(5)
    pairs = [(rng.normal(0, 1, int(rng.integers(12, 61))).astype(np.float32),
              rng.normal(0, 1, int(rng.integers(12, 61))).astype(np.float32))
             for _ in range(64)]
    pairs.append((rng.normal(0, 1, 512).astype(np.float32),
                  rng.normal(0, 1, 500).astype(np.float32)))
    radii = rng.integers(1, 17, len(pairs))
    got = dtw_banded_batch_host(pairs, radii, device=cuda_device)
    want = dtw_banded_batch_host(pairs, radii, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
