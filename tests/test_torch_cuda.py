"""The CUDA kernels on a card, against their plain PyTorch versions.

These need an NVIDIA GPU and skip without one.  They import no jax, so on a
machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch.chain.backtrack import chain_backtrack  # noqa: E402
from rawhash_tpu_torch.chain.backtrack_device import backtrack_plain  # noqa: E402
from rawhash_tpu_torch.chain.device import chain_fill_batch  # noqa: E402
from rawhash_tpu_torch.chain.fill import chain_fill  # noqa: E402
from rawhash_tpu_torch.map.engine import fill_params  # noqa: E402
from rawhash_tpu_torch.synthetic import options, random_chains  # noqa: E402


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
    before = chain_fill.launches
    f, p = chain_fill(*args, **prm)
    f0, p0 = chain_fill_batch(*args, **prm)
    torch.cuda.synchronize()
    assert chain_fill.launches == before + 1
    assert torch.equal(f, f0) and torch.equal(p, p0)


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
def test_chain_backtrack_rejects_wrong_dtype_or_device(cuda_device):
    f, p, n_anchors, tpos, qpos = (torch.from_numpy(x).to(cuda_device)
                                   for x in random_chains(1, 2, 64, 8))
    with pytest.raises(ValueError):
        chain_backtrack(f.long(), p, n_anchors, tpos, qpos, **BT, k_cap=8)
    with pytest.raises(ValueError):
        chain_backtrack(f, p.cpu(), n_anchors, tpos, qpos, **BT, k_cap=8)
    with pytest.raises(ValueError):
        chain_backtrack(f, p, n_anchors, tpos, qpos, **BT, k_cap=0)
