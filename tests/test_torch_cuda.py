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
from rawhash_tpu_torch.chain.backtrack_device import (  # noqa: E402
    backtrack_compact, backtrack_plain,
)
from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.chain.fill import MAX_ITER_CAP, chain_fill  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.profiling.bounds import fill_work  # noqa: E402
from rawhash_tpu_torch.profiling.fill_loop_overhead import (  # noqa: E402
    INT32_MIN, MAX_W, fill_loop_probe, fill_loop_probe_plain, measure_latencies,
)
from rawhash_tpu_torch.signal import events as ev  # noqa: E402
from rawhash_tpu_torch.sketch import device as sk  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    ava_fixture_reads, border_anchors, clustered_anchors, event_tstats, options,
    peak_handoff_tstats, random_chains, signal_chunk, sparse_anchors,
    wide_band_anchors,
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 33024])
def test_backtrack_compact_on_the_card_matches_cpu(cuda_device, n):
    """The standalone backtrack + compaction: its kernel route (one launch
    of chain_backtrack, K2's widths and past 32768 K3's) against its CPU
    route on the same inputs, every output whole, bit for bit."""
    f, p, n_anchors, tpos, qpos = random_chains(n, 8, n, min(120, n // 4))
    key = np.random.default_rng(n).integers(-2**31, 2**31, (8, n)).astype(np.int32)
    host = [torch.from_numpy(x) for x in (f, p, n_anchors, key, tpos, qpos)]
    before = chain_backtrack.launches
    got = backtrack_compact(*(t.to(cuda_device) for t in host), **BT, k_cap=64)
    torch.cuda.synchronize()
    assert chain_backtrack.launches == before + 1
    want = backtrack_compact(*host, **BT, k_cap=64)
    assert chain_backtrack.launches == before + 1
    for a, c in zip(want, got):
        assert torch.equal(a, c.cpu())
    assert int(want[1].min()) > 0


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
@pytest.mark.parametrize("k_ops", [2, 7, 60])
@pytest.mark.parametrize("w", [33, 64, 200, 257])
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
def test_probe_latencies_measure(cuda_device):
    lat = measure_latencies(64, 4)
    assert all(v > 0 for v in lat.values()), lat


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
    """The banded DTW on the card (the kernel, one launch) against its CPU
    run (the plain version): pairs of 12-60 events plus one of 512,
    per-pair radii 1-16, every cost bit-equal."""
    from rawhash_tpu_torch.dtw.device import dtw_banded_batch, dtw_banded_batch_host

    rng = np.random.default_rng(5)
    pairs = [(rng.normal(0, 1, int(rng.integers(12, 61))).astype(np.float32),
              rng.normal(0, 1, int(rng.integers(12, 61))).astype(np.float32))
             for _ in range(64)]
    pairs.append((rng.normal(0, 1, 512).astype(np.float32),
                  rng.normal(0, 1, 500).astype(np.float32)))
    radii = rng.integers(1, 17, len(pairs))
    before = dtw_banded_batch.launches
    got = dtw_banded_batch_host(pairs, radii, device=cuda_device)
    assert dtw_banded_batch.launches == before + 1
    want = dtw_banded_batch_host(pairs, radii, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1, 5, 4, 8, 16, 32, 48, 64, 80, 96, 127, 128, 256, 512])
def test_dtw_banded_kernel_matches_plain(cuda_device, r):
    """K8 against the plain version at widths 1, 3, 11 and 9-513 (the bands
    in shared memory) and 1025 (past it: the thread path's bands in a
    global scratch), with the edge cases of tests/test_torch_dtw_kernel.py,
    through the padded entry: the kernel's own choice of paths, every pair
    on a warp (threshold 0; widths 65-255 take the warp path's lags 3-8)
    and every pair on a thread; bit-equal, one launch a call."""
    from rawhash_tpu_torch.dtw import device as dd
    from test_torch_dtw_kernel import batch

    rng = np.random.default_rng(r)
    max_len = max(40, 2 * r + 24) if r <= 64 else r + 40
    args = [torch.from_numpy(x) for x in batch(rng, 24 if r >= 256 else 300, max_len, r)]
    want = dd.dtw_banded_batch_plain(*args, max_radius=r)
    width = 2 * r + 1
    runs = [{}, {"threshold": 2 ** 30}, {"threshold": 0}]
    on_card = [x.to(cuda_device) for x in args]
    for kw in runs:
        before = dd.dtw_banded_batch.launches
        got = dd.dtw_banded_batch(*on_card, max_radius=r, **kw)
        torch.cuda.synchronize()
        assert dd.dtw_banded_batch.launches == before + 1
        assert torch.equal(got.cpu(), want), kw
    assert (width > dd.kernel("rh_dtw_shared_width", [])()) == (r == 512)


@pytest.mark.cuda
@pytest.mark.parametrize("r_frac", [0.1, 0.3])
def test_dtw_banded_ragged_on_a_dtw_cell_shaped_batch(cuda_device, r_frac):
    """A batch shaped like the dtw cell's call: 6000 pairs of 1-7 events
    and eight of 150-512 (band radii up to 16 or 48), through the host
    wrapper (packed ragged, one launch) and the ragged entry with each
    path forced, against the plain version on the pairs padded: every cost
    bit-equal, one launch a call."""
    from rawhash_tpu_torch.dtw import device as dd

    rng = np.random.default_rng(int(r_frac * 10))
    lens = np.concatenate([rng.integers(1, 8, 6000), rng.integers(150, 513, 8)])
    rng.shuffle(lens)
    pairs = []
    for n in lens:
        m = max(1, int(n) - int(rng.integers(0, max(2, int(n) // 8))))
        x = rng.normal(0, 1, int(n)).astype(np.float32)
        y = rng.normal(0, 1, m).astype(np.float32)
        pairs.append((x, y) if rng.random() < 0.5 else (y, x))
    radii = [max(1, int(min(int(n), 160) * r_frac)) for n in lens]
    want = dd.dtw_banded_batch_host(pairs, radii, device="cpu")
    before = dd.dtw_banded_batch.launches
    got = dd.dtw_banded_batch_host(pairs, radii, device=cuda_device)
    assert dd.dtw_banded_batch.launches == before + 1
    np.testing.assert_array_equal(got, want)
    values, *ints, n_long = dd.pack_pairs(pairs, radii)
    assert n_long == 8
    on_card = [torch.from_numpy(x).to(cuda_device) for x in (values, *ints)]
    r = dd._pow2_at_least(max(radii), 4)
    for kw in ({"long_pairs": n_long}, {"threshold": 0}, {"threshold": 2 ** 30}, {}):
        before = dd.dtw_banded_batch.launches
        got = dd.dtw_banded_ragged(*on_card, max_radius=r, **kw)
        torch.cuda.synchronize()
        assert dd.dtw_banded_batch.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=str(kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["host", "device"])
def test_pipeline_depth_3_on_the_card_matches_depth_1(cuda_device, monkeypatch, tail):
    """Four batches of four viral reads at --pipeline-depth 3 on the card:
    the records of depth 1; at depth 1 every K1 launch is on the default
    stream, at depth 3 on more than one stream of its own (one a batch in
    flight), never the default one."""
    from rawhash_tpu_torch.map import device_step
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.synthetic import deployment

    if tail == "device":
        monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    else:
        monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
    index, mopt, reads = deployment(20_000, "viral", 16, 900, 1024, 17)
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 4]] for i in range(0, 16, 4)]
    streams = []
    fill = device_step.chain_fill

    def spy(*a, **k):
        streams.append(torch.cuda.current_stream(a[0].device).cuda_stream)
        return fill(*a, **k)
    monkeypatch.setattr(device_step, "chain_fill", spy)
    recs, used = {}, {}
    for depth in (1, 3):
        mopt.pipeline_depth = depth
        streams.clear()
        backtracks = chain_backtrack.launches
        engine = MappingEngine(index, mopt, device=cuda_device)
        recs[depth] = [
            (r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped)
                      for m in r.records])
            for results in engine.map_stream(batches) for r in results]
        used[depth] = set(streams)
        assert (chain_backtrack.launches > backtracks) == (tail == "device")
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert recs[3] == recs[1]
    assert sum(m[-1] for _, rs in recs[1] for m in rs) >= 8
    assert used[1] == {default}
    assert len(used[3]) > 1 and default not in used[3]


PEAKS = dict(t1=4.0, t2=3.5, w1=3, w2=9, peak_height=0.4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(5, 33), (70, 4000), (256, 4000), (16, 28672),
                                 (37, 95), (4, 160)])
def test_gen_peaks_kernel_matches_plain(cuda_device, b, l):
    """The peak detector's kernel against the plain detector on the same
    t-statistics: rows of different lengths (0, 1, under 2 w2, all of L,
    past it), a batch that is not a multiple of 32 reads, L not a multiple
    of the kernel's 32-position tile; at 4 x 160, the rows whose detectors
    act across the tiles (the short detector's mask reaching into the next
    tile, a long peak pending across a tile edge)."""
    rng = np.random.default_rng(l + b)
    if (b, l) == (4, 160):
        ts1, ts2, n_sig = peak_handoff_tstats()
    else:
        n_sig = rng.integers(0, l + 1, b).astype(np.int32)
        n_sig[:5] = [l, 0, min(l, 17), l + 3, 1][:b]
        ts1, ts2 = event_tstats(rng, b, l, n_sig, PEAKS["w1"], PEAKS["w2"])
    args = [torch.from_numpy(x) for x in (ts1, ts2, n_sig)]
    before = ev._gen_peaks.launches
    got = ev._gen_peaks(*(a.to(cuda_device) for a in args), **PEAKS)
    torch.cuda.synchronize()
    assert ev._gen_peaks.launches == before + 1
    want = ev._gen_peaks_plain(*args, **PEAKS)
    assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 5, 15, 16, 17, 31, 32, 33, 255, 256, 257, 1000, 1023,
                               1025, 4000, 4001, 4095, 4097, 8192, 28672, 57344])
def test_ordered_scan_kernels_match_plain(cuda_device, l):
    """The ordered prefix sum and sum on the card against the plain versions
    (XLA's CPU order), on contiguous rows and on rows of a wider array, and
    a value and its square in one launch (the prefix sum with its leading
    zero) against the two single plain calls (a warp a row up to 8192
    values, 8 warps a row past them; 57344 has three levels above the
    row)."""
    rng = np.random.default_rng(l)
    wide = torch.from_numpy(rng.normal(0, 3, (37, l + 5)).astype(np.float32))
    for x in (wide[:, :l].contiguous(), wide[:, 2:l + 2]):
        xc = x.to(cuda_device) if x.is_contiguous() else wide.to(cuda_device)[:, 2:l + 2]
        before = (ev.ordered_cumsum.launches, ev.ordered_sum.launches)
        cum, tot = ev.ordered_cumsum(xc), ev.ordered_sum(xc)
        torch.cuda.synchronize()
        assert (ev.ordered_cumsum.launches, ev.ordered_sum.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(cum.cpu(), ev.ordered_cumsum_plain(x))
        assert torch.equal(tot.cpu(), ev.ordered_sum_plain(x))
        want_cum = ev.ordered_cumsum_plain(x, squares=True, lead_zero=True)
        want_tot = ev.ordered_sum_plain(x, squares=True)
        got = (*ev.ordered_cumsum(xc, squares=True, lead_zero=True),
               *ev.ordered_sum(xc, squares=True))
        for g, w in zip(got, (*want_cum, *want_tot)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("squares", [False, True])
def test_ordered_scan_kernels_on_two_devices(cuda_device, squares):
    """The ordered sums on cuda:0, then on cuda:1 while cuda:0 is current:
    at 256 x 4000 both kernels take more than 48 KB of shared memory, a
    limit raised for each device on its own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 3, (256, 4000)).astype(np.float32))
    want = (ev.ordered_cumsum_plain(x, squares=squares, lead_zero=True),
            ev.ordered_sum_plain(x, squares=squares))
    torch.cuda.set_device(0)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        xd = x.to(dev)
        got = (ev.ordered_cumsum(xd, squares=squares, lead_zero=True),
               ev.ordered_sum(xd, squares=squares))
        torch.cuda.synchronize(dev)
        for g, w in zip(got, want):
            for u, v in zip(*((t if squares else (t,)) for t in (g, w))):
                assert u.device == dev and torch.equal(u.cpu(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,n_lo,n_hi", [
    (3, 33, 0, 33), (37, 100, 0, 100), (70, 48, 0, 48), (256, 768, 0, 768),
    (40, 16384, 0, 16384), (256, 16384, 3000, 3440)])
def test_diff_filter_kernel_matches_plain(cuda_device, b, e, n_lo, n_hi):
    """n_ev 0, 1 and the longest: event 0 is kept whenever n_ev > 0.  E not
    a multiple of 16 (33, 100: scalar loads and byte stores), a half tile
    at the end (48), and the ava shape with ~3440 events a read (most
    bytes the fill blocks')."""
    rng = np.random.default_rng(e + n_lo)
    events = (np.round(rng.normal(0, 1.0, (b, e)) / 0.05) * 0.05).astype(np.float32)
    n_ev = rng.integers(n_lo, n_hi + 1, b).astype(np.int32)
    n_ev[:3] = [0, 1, n_hi]
    args = [torch.from_numpy(x) for x in (events, n_ev)]
    before = sk._diff_filter.launches
    got = sk._diff_filter(*(a.to(cuda_device) for a in args), 0.35)
    torch.cuda.synchronize()
    assert sk._diff_filter.launches == before + 1
    want = sk._diff_filter_plain(*args, 0.35)
    assert torch.equal(got.cpu(), want)
    assert not want[0].any() and bool(want[1, 0]) and not want[1, 1:].any()


@pytest.mark.cuda
def test_event_kernels_reject_mixed_devices(cuda_device):
    ts = torch.zeros((4, 64), device=cuda_device)
    with pytest.raises(ValueError):
        ev._gen_peaks(ts, ts, torch.zeros(4, dtype=torch.int32), **PEAKS)
    with pytest.raises(ValueError):
        sk._diff_filter(ts, torch.zeros(4, dtype=torch.int32), 0.35)
    with pytest.raises(ValueError):
        ev.ordered_cumsum(ts.t())


def _events_and_sketch(sig, slen, preset):
    from rawhash_tpu_torch.map.device_step import events_and_sketch

    io, mo = options(preset)
    return events_and_sketch(
        sig, slen, ev.NormCarry.zeros(sig.shape[0], sig.device),
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height, e_cap=mo.max_events_per_chunk,
        min_events=mo.min_events, diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range)


@pytest.mark.cuda
def test_events_and_sketch_on_the_card(cuda_device):
    """The events and sketch stage on the card launches the events stage's
    three kernels in one call (events_fused) and the filter once, and none
    of the events stage's single kernels (the detector, the ordered sums),
    with no sync: the same torch ops at L = 4000 and 8000, none of them
    reading a value back."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    ops = {}
    for l in (4000, 8000):
        sig = torch.from_numpy(signal_chunk(np.random.default_rng(l), 64, l)).to(cuda_device)
        slen = torch.full((64,), l, dtype=torch.int32, device=cuda_device)
        _events_and_sketch(sig, slen, "viral")  # warm-up: the library is built
        counters = (ev.events_fused, sk._diff_filter, ev._gen_peaks, ev.ordered_cumsum,
                    ev.ordered_sum)
        before = [f.launches for f in counters]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with Count() as count:
                out = _events_and_sketch(sig, slen, "viral")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ops[l] = count.n
        assert [f.launches - n for f, n in zip(counters, before)] == [3, 1, 0, 0, 0]
        assert int(out[1].min()) > 50 and bool(out[6].any())
    assert ops[4000] == ops[8000]


def _d2_reads(n, seed=23):
    """n D2-like reads (2500 bases each from a random genome, the signal
    generator's pore), as signals."""
    from rawhash_tpu_torch.io.signal_gen import simulate_reads
    from rawhash_tpu_torch.pore import synthetic_pore
    from rawhash_tpu_torch.synthetic import random_genome

    rng = np.random.default_rng(seed)
    genome = random_genome(200_000, rng)
    return [s for _, s, _, _ in simulate_reads(genome, synthetic_pore(k=6), n_reads=n,
                                               read_len=2500, rng=rng)]


def _chunk(reads, c, l):
    """Chunk c of the reads (l samples each) as the engine assembles it:
    f16 [B, l] zero-padded, and each row's samples."""
    sig = np.zeros((len(reads), l), np.float32)
    slen = np.zeros(len(reads), np.int32)
    for i, s in enumerate(reads):
        seg = s[c * l:(c + 1) * l]
        sig[i, :seg.shape[0]] = seg
        slen[i] = seg.shape[0]
    return torch.from_numpy(sig.astype(np.float16)), torch.from_numpy(slen)


def _stage_outputs(out):
    events, n_ev, carry = out
    return (events, n_ev, *carry)


EVENT_CASES = {  # preset, rows, chunk length, e_cap
    "viral": ("viral", 256, 4000, 768),
    "d2": ("sensitive", 256, 4000, 768),
    "d2_last_chunk": ("sensitive", 256, 4000, 768),
    "f32": ("viral", 64, 4000, 768),
    "ava": ("ava", 16, 28672, 16384),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EVENT_CASES))
def test_events_stage_kernels_match_cpu(cuda_device, case):
    """The events stage on the card (events_fused: three kernels, one call)
    equals detect_events_batch on the CPU bit for bit: events, counts and
    the carry, on nanopore-like viral chunks, D2-like reads' chunks 0 and 5
    (the last, on the carry of chunks 0-4, every read ending inside it),
    f32 samples, and ava's 28672-sample rows (both row programs in global
    memory)."""
    preset, b, l, e_cap = EVENT_CASES[case]
    _, mo = options(preset)
    prm = dict(window_length1=mo.window_length1, window_length2=mo.window_length2,
               threshold1=mo.threshold1, threshold2=mo.threshold2,
               peak_height=mo.peak_height, e_cap=e_cap)
    carry = ev.NormCarry.zeros(b, "cpu")
    if case.startswith("d2"):
        reads = _d2_reads(b)
        sig, slen = _chunk(reads, 0, l)
        if case == "d2_last_chunk":  # chunk 5, where every read ends
            for c in range(1, 6):
                carry = ev.detect_events_batch(sig, slen, carry, **prm)[2]
                sig, slen = _chunk(reads, c, l)
            assert (slen < l).all() and (slen > 0).all()
    else:
        sig = torch.from_numpy(signal_chunk(np.random.default_rng(l + b), b, l))
        sig = sig if case == "f32" else sig.half()
        slen = torch.full((b,), l, dtype=torch.int32)
    want = ev.detect_events_batch(sig, slen, carry, **prm)
    dev_carry = ev.NormCarry(*(c.to(cuda_device) for c in carry))
    before = ev.events_fused.launches, ev.events_fused.calls, ev.events_fused.wide_calls
    got = ev.detect_events_batch(sig.to(cuda_device), slen.to(cuda_device), dev_carry, **prm)
    torch.cuda.synchronize()
    assert ev.events_fused.launches == before[0] + 3
    assert ev.events_fused.calls == before[1] + 1
    assert ev.events_fused.wide_calls == before[2] + (case == "ava")
    for g, w in zip(_stage_outputs(got), _stage_outputs(want)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert int(want[1].float().mean()) > 50


@pytest.mark.cuda
def test_events_stage_rows_on_the_card_against_the_cpu(cuda_device, monkeypatch):
    """The rows of D2-like chunks whose events differ from the CPU path's,
    before this stage's kernels (the op chain on the card against the op
    chain on the CPU, both with torch's f32 sqrt, which is off by an ulp on
    some values on the CPU) and after (the kernels against the CPU path):
    none after."""
    _, mo = options("sensitive")
    prm = dict(window_length1=mo.window_length1, window_length2=mo.window_length2,
               threshold1=mo.threshold1, threshold2=mo.threshold2,
               peak_height=mo.peak_height, e_cap=768)
    reads = _d2_reads(512, seed=29)
    differ = {"before": 0, "after": 0}
    rows = 0
    for start in (0, 256):
        sig, slen = _chunk(reads[start:start + 256], 0, 4000)
        carry = ev.NormCarry.zeros(256, "cpu")
        dev = [sig.to(cuda_device), slen.to(cuda_device),
               ev.NormCarry.zeros(256, cuda_device)]
        cpu_now = ev.detect_events_batch(sig, slen, carry, **prm)
        card_now = ev.detect_events_batch(*dev, **prm)
        with monkeypatch.context() as m:
            m.setattr(ev, "sqrt_rn", torch.sqrt)
            cpu_then = ev.detect_events_batch_plain(sig, slen, carry, **prm)
            card_then = ev.detect_events_batch_plain(*dev, **prm)
        for key, (a, c) in {"before": (card_then, cpu_then),
                            "after": (card_now, cpu_now)}.items():
            differ[key] += int((a[0].cpu() != c[0]).any(1).sum())
        rows += 256
    print(f"rows whose events differ from the CPU path's, of {rows}: {differ}")
    assert differ["after"] == 0


@pytest.mark.cuda
def test_events_stage_launches_three_kernels_and_counts_each_step(cuda_device, monkeypatch):
    """The engine's events stage is three kernels a chunk step on the card,
    and engine.stats counts each chunk step that took them (none of the
    fixture's rows stage in global memory)."""
    from torch.profiler import ProfilerActivity, profile

    from rawhash_tpu_torch.map import engine as eng_mod
    from rawhash_tpu_torch.synthetic import deployment

    index, mopt, reads = deployment(20_000, "viral", 16, 900, 1024, 17)
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 4]] for i in range(0, 16, 4)]
    steps = []
    step = eng_mod.chunk_step

    def spy(*a, **k):
        steps.append(a[1].shape)
        return step(*a, **k)
    monkeypatch.setattr(eng_mod, "chunk_step", spy)
    engine = eng_mod.MappingEngine(index, mopt, device=cuda_device)
    for _ in engine.map_stream(batches):
        pass
    assert len(steps) > len(batches)
    assert engine.stats["events_fused_steps"] == len(steps)
    assert engine.stats["events_fused_wide_steps"] == 0

    b, l = steps[0]
    sig = torch.from_numpy(signal_chunk(np.random.default_rng(5), b, l)).half().to(cuda_device)
    slen = torch.full((b,), l, dtype=torch.int32, device=cuda_device)
    carry = ev.NormCarry.zeros(b, cuda_device)
    ev.detect_events_batch(sig, slen, carry)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.detect_events_batch(sig, slen, carry)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3, kernels
    for name, kernel in zip(("events_norm_kernel", "events_peaks_kernel",
                             "events_segments_kernel"), kernels):
        assert name in kernel, kernels
