"""The fill-loop-overhead probe: the plain PyTorch probe against the JAX
probe (tools/profiling/fill_loop_overhead.py, its Pallas kernel run by the
interpreter), and the CUDA kernel's own iteration (csrc/fill_loop_probe.cuh
through csrc/fill_loop_probe_host.cpp, built here with g++: the serial
order and every warp instance the kernel picks, with the lanes as a loop)
against the plain probe, bit for bit.  The kernel itself runs on a card in
test_torch_cuda.py."""

import ctypes
import importlib.util
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from rawhash_tpu_torch._build import load_host_library  # noqa: E402
from rawhash_tpu_torch.profiling import fill_loop_overhead as flo  # noqa: E402
from rawhash_tpu_torch.profiling.fill_loop_overhead import (  # noqa: E402
    INT32_MIN, fill_loop_probe, fill_loop_probe_plain,
)

REPO = Path(__file__).resolve().parent.parent
INT32_MAX = 2**31 - 1


def _seeded_interpret_call(kern, **kw):
    """pl.pallas_call in interpret mode, of the probe's kernel started the
    port's way: the ring from x, the carry (row 0 of mii) from INT32_MIN.
    The TPU kernel itself starts both from uninitialised scratch."""
    def seeded(x_ref, o_ref, ring, mii):
        ring[:, :] = x_ref[:, :]
        mii[pl.ds(0, 1), :] = jnp.full((1, mii.shape[1]), INT32_MIN, jnp.int32)
        kern(x_ref, o_ref, ring, mii)

    return pl.pallas_call(seeded, interpret=True, **kw)


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    """The JAX probe module, loaded from its file with the repository root on
    sys.path and its compile cache in a temporary directory; its Pallas
    calls run in interpret mode, from the port's start (see
    `_seeded_interpret_call`).  sys.path, the environment and the jax cache
    settings it changes are put back afterwards."""
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "path", [str(REPO), *sys.path])
    mp.setenv("RAWHASH_TPU_CACHE", str(tmp_path_factory.mktemp("xla_cache")))
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_fill_loop_overhead", REPO / "tools/profiling/fill_loop_overhead.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.pl = types.SimpleNamespace(
            **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
        mod.pl.pallas_call = _seeded_interpret_call
        yield mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        mp.undo()


@pytest.mark.parametrize("n_iter,k_ops", [(1, 2), (7, 20), (300, 60)])
def test_plain_matches_jax_probe_interpret(jax_probe, n_iter, k_ops):
    w, b = jax_probe.W, jax_probe.B
    x = np.full((w, b), INT32_MIN, np.int32)
    want = np.asarray(jax_probe.make(n_iter, k_ops, 8)(jnp.asarray(x)))
    got = fill_loop_probe_plain(torch.from_numpy(x), n_iter, k_ops)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, INT32_MIN + k_ops * n_iter)


@pytest.mark.parametrize("seed,n_iter,k_ops,lo,hi", [
    (11, 1, 2, -1000, 1000),
    (12, 7, 20, -10**6, 10**6),
    (13, 130, 3, -50, 50),  # past W, so every ring slot is written twice
    (14, 1, 2, INT32_MAX - 6, INT32_MAX),  # wraps past INT32_MAX
])
def test_plain_matches_jax_probe_interpret_from_x(jax_probe, seed, n_iter, k_ops, lo, hi):
    """From a random start, so the carry's max, the column max and the slot
    write each change the ring."""
    w, b = jax_probe.W, jax_probe.B
    x = np.random.default_rng(seed).integers(lo, hi, (w, b), endpoint=True).astype(np.int32)
    want = np.asarray(jax_probe.make(n_iter, k_ops, 8)(jnp.asarray(x)))
    got = fill_loop_probe_plain(torch.from_numpy(x), n_iter, k_ops)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("start", [INT32_MIN, -5, 1000])
@pytest.mark.parametrize("w,n_iter,k_ops", [(64, 9, 2), (37, 40, 20), (200, 3, 60)])
def test_uniform_start_closed_form(start, w, n_iter, k_ops):
    """From a uniform start v every iteration adds k_ops to every slot."""
    x = torch.full((w, 5), start, dtype=torch.int32)
    got = fill_loop_probe_plain(x, n_iter, k_ops)
    assert torch.equal(got, torch.full_like(x, start + k_ops * n_iter))


def test_cpu_dispatch_is_plain_and_not_counted():
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -1000, 1000, (40, 6)).astype(np.int32))
    before = fill_loop_probe.launches
    got = fill_loop_probe(x, 25, 3)
    assert torch.equal(got, fill_loop_probe_plain(x, 25, 3))
    assert fill_loop_probe.launches == before
    assert not torch.equal(got, x)  # the input is left as it was


@pytest.mark.parametrize("bad", [
    torch.zeros((8, 4), dtype=torch.int64),
    torch.zeros((8, 4), dtype=torch.float32),
    torch.zeros(8, dtype=torch.int32),
    torch.zeros((2, 8, 4), dtype=torch.int32),
    torch.zeros((0, 4), dtype=torch.int32),
    torch.zeros((flo.MAX_W + 1, 1), dtype=torch.int32),
    torch.zeros((4, 8), dtype=torch.int32).t(),
])
def test_wrong_input_raises(bad):
    with pytest.raises(ValueError):
        fill_loop_probe(bad, 3, 2)


@pytest.mark.parametrize("n_iter,k_ops", [(-1, 2), (3, -1)])
def test_negative_counts_raise(n_iter, k_ops):
    with pytest.raises(ValueError):
        fill_loop_probe(torch.zeros((8, 4), dtype=torch.int32), n_iter, k_ops)


no_card = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the probe's exit without a CUDA device")


@no_card
def test_main_without_a_card_exits_nonzero(capsys):
    assert flo.main(["10"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@no_card
def test_module_entry_point_without_a_card_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, "-m", "rawhash_tpu_torch.profiling.fill_loop_overhead", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture(scope="module")
def harness():
    """The kernel's header built as host C++ (csrc/fill_loop_probe_host.cpp):
    the serial column order and the warp forms with the lanes as a loop."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel-logic harness")
    lib = load_host_library("fill_loop_probe")
    for fn in (lib.rh_probe_serial, lib.rh_probe_warp):
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.rh_probe_warp.restype = ctypes.c_int
    lib.rh_probe_chain1.argtypes = [ctypes.c_int] * 3
    lib.rh_probe_chain1.restype = ctypes.c_int
    return lib


def _host_forms(harness, x, n_iter, k_ops):
    """The ring after n_iter iterations from x by the serial order and by the
    warp form the kernel picks, and that form's SPL (0: shared memory)."""
    w, b = x.shape
    serial, warp = x.copy(), x.copy()
    harness.rh_probe_serial(serial.ctypes.data_as(ctypes.c_void_p), w, b, n_iter, k_ops)
    spl = harness.rh_probe_warp(warp.ctypes.data_as(ctypes.c_void_p), w, b, n_iter, k_ops)
    return serial, warp, spl


@pytest.mark.parametrize("seed,w,b,n_iter,k_ops,lo,hi", [
    (1, 64, 16, 50, 2, -10**6, 10**6),
    (2, 200, 8, 30, 20, -10**4, 10**4),
    (3, 37, 5, 45, 7, INT32_MIN, INT32_MIN + 100),
    (4, 33, 6, 1, 3, INT32_MAX - 100, INT32_MAX),  # wraps past INT32_MAX
    (5, 33, 6, 40, 3, INT32_MAX - 100, INT32_MAX),
])
def test_kernel_iteration_matches_plain(harness, seed, w, b, n_iter, k_ops, lo, hi):
    x = np.random.default_rng(seed).integers(lo, hi, (w, b), endpoint=True).astype(np.int32)
    serial, warp, _ = _host_forms(harness, x, n_iter, k_ops)
    want = fill_loop_probe_plain(torch.from_numpy(x), n_iter, k_ops).numpy()
    np.testing.assert_array_equal(serial, want)
    np.testing.assert_array_equal(warp, want)
    if lo > 0 and n_iter == 1:
        assert (want < 0).any()  # slots that passed INT32_MAX wrapped around
    elif lo > 0:
        # wrapped slots fall below the carry, so the column max holds every
        # slot at INT32_MAX (wider adds would have gone past it)
        assert (want == INT32_MAX).all()


@pytest.mark.parametrize("k_ops", [0, 2, 7, 20, 60])  # 7, 0: the runtime-k_ops instances
@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 200, 256, 257, 1000])
def test_warp_forms_match_plain(harness, w, k_ops):
    """Every warp instance the kernel picks (the ring in registers, SPL =
    ceil(W/32) entries a lane, up to W = 256; in shared memory past it)
    against the plain probe, from a random start and from starts that wrap
    past INT32_MAX or sit at INT32_MIN; masked entries (W % 32 != 0) must
    stay out of the column max."""
    n_iter = min(w, 64) + 7  # every slot written at least once up to W = 64
    rng = np.random.default_rng(w * 100 + k_ops)
    for lo, hi in ((-10**6, 10**6), (INT32_MAX - 100, INT32_MAX),
                   (INT32_MIN, INT32_MIN + 100)):
        for it in (1, n_iter):
            x = rng.integers(lo, hi, (w, 3), endpoint=True).astype(np.int32)
            serial, warp, spl = _host_forms(harness, x, it, k_ops)
            want = fill_loop_probe_plain(torch.from_numpy(x), it, k_ops).numpy()
            np.testing.assert_array_equal(serial, want)
            np.testing.assert_array_equal(warp, want)
            assert spl == (-(-w // 32) if w <= 256 else 0)


@pytest.mark.parametrize("r,acc,k_ops,want", [
    (5, 0, 3, 8), (-7, 100, 2, 101), (INT32_MAX, INT32_MIN, 1, INT32_MIN),
    (INT32_MAX - 1, -3, 4, -1), (12, INT32_MIN, 0, 12),
])
def test_kernel_chain_wraps_like_int32(harness, r, acc, k_ops, want):
    assert harness.rh_probe_chain1(r, acc, k_ops) == want
    got = fill_loop_probe_plain(torch.tensor([[r]], dtype=torch.int32), 1, k_ops)
    if acc == INT32_MIN:  # the plain probe's first carry
        assert int(got) == want
