"""The port's seeding filters (rawhash_tpu_torch/map/seedfilt.py) against
the JAX package's (rawhash_tpu/map/seedfilt.py), mask for mask on the same
numpy inputs: the random trials and edge cases of tests/test_seedfilt.py,
a streak past the 128-hit cap, spans whose span/dist sits at .5 +/- 1e-3
(the + 0.499 rounding), and query hashes repeated exactly n * q_occ_frac
times (the strict >).  Both filters are host numpy in both packages and
dormant in both, as in the reference (docs/PARITY.md)."""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from rawhash_tpu.map import seedfilt as jax_sf  # noqa: E402
from rawhash_tpu_torch.map import seedfilt as sf  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def same_select(*args, **kw):
    got = sf.seed_select(*args, **kw)
    want = jax_sf.seed_select(*args, **kw)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    return got


def same_freq(*args):
    got = sf.query_freq_filter(*args)
    want = jax_sf.query_freq_filter(*args)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    return got


def random_trials():
    """tests/test_seedfilt.py's 50 random trials, drawn in its order."""
    rng = np.random.default_rng(0)
    trials = []
    for _ in range(50):
        n = int(rng.integers(0, 60))
        occ = rng.integers(1, 40, size=n)
        q_pos = np.sort(rng.integers(0, 1000, size=n))
        max_occ = int(rng.integers(2, 20))
        max_max_occ = int(rng.integers(max_occ, 50))
        dist = int(rng.choice([50, 100, 500]))
        trials.append((occ, q_pos, 1000, max_occ, max_max_occ, dist))
    return trials


TRIALS = random_trials()


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_seed_select_random_trials(trial):
    same_select(*TRIALS[trial])


@pytest.mark.parametrize("args,want", [
    (([1, 2, 3], [10, 20, 30], 100, 5, 10, 50), [False] * 3),
    (([99], [10], 100, 5, 10, 50), [False]),
    (([], [], 100, 5, 10, 50), []),
    (([50, 50, 1, 50], [0, 1, 2, 3], 4, 5, 100, 1000), [True, True, False, True]),
    (([10, 30, 20, 1], [0, 100, 200, 300], 400, 5, 100, 150),
     [False, True, False, False]),
    (([10, 500], [0, 100], 400, 5, 100, 50), [False, True]),
    (([7, 7, 7, 7], [0, 10, 20, 30], 40, 5, 100, 20), [False, False, True, True]),
])
def test_seed_select_edges(args, want):
    """tests/test_seedfilt.py's edge cases: no high-occurrence hit, one
    hit, none, streaks at both ends with k = 0, the lowest occurrences
    kept, max_max_occ over the selection, ties to the earlier hit."""
    assert same_select(*args).tolist() == want


@pytest.mark.parametrize("n", [129, 200, 300])
def test_seed_select_caps_a_streak_at_128(n):
    """One streak of n > 128 high-occurrence hits with room for more than
    128 (k = round(span/dist) > n): exactly MAX_MAX_HIGH_OCC kept, the
    lowest occurrences, ties to the earlier hit."""
    assert sf.MAX_MAX_HIGH_OCC == jax_sf.MAX_MAX_HIGH_OCC == 128
    rng = np.random.default_rng(n)
    occ = rng.integers(6, 12, size=n)
    q_pos = np.arange(n) * 10
    flt = same_select(occ, q_pos, 10 * n, 5, 100, 1)
    assert (~flt).sum() == 128
    kept = np.lexsort((np.arange(n), occ))[:128]
    assert not flt[kept].any()


@pytest.mark.parametrize("m", [0, 1, 2, 7])
@pytest.mark.parametrize("dist", [1000, 2000])
@pytest.mark.parametrize("delta", [-1e-3, 0.0, 1e-3])
def test_seed_select_rounds_half_spans(m, dist, delta):
    """A streak of 10 high-occurrence hits between two low ones whose span
    is (m + .5 + delta) x dist: k = int(span/dist + 0.499), so m kept at .5
    and below, m + 1 above."""
    span = int(round((m + 0.5 + delta) * dist))
    occ = np.array([1] + list(range(10, 20)) + [1])
    q_pos = np.array([0] + list(range(1, 11)) + [span])
    flt = same_select(occ, q_pos, span + 10, 5, 100, dist)
    assert (~flt[1:-1]).sum() == min(m + (delta > 0), 10)


@pytest.mark.parametrize("n,frac", [(100, 0.25), (40, 0.5), (64, 0.125)])
def test_query_freq_filter_at_the_threshold(n, frac):
    """A hash repeated exactly n * q_occ_frac times is kept (the strict >),
    one repeated once more is dropped."""
    reps = int(n * frac)
    at = [7] * reps
    over = [9] * (reps + 1)
    rest = list(range(1000, 1000 + n - len(at) - len(over)))
    h = np.array(at + over + rest)
    keep = same_freq(h, n // 2, frac)
    assert keep[:reps].all() and not keep[reps:2 * reps + 1].any()
    assert keep[2 * reps + 1:].all()


@pytest.mark.parametrize("args", [
    (np.array([1, 1, 1, 2]), 10, 0.01),
    (np.array([5] * 90 + list(range(100, 110))), 50, 0.5),
    (np.array([5] * 90 + list(range(100, 110))), 50, 0.0),
    (np.array([5] * 90 + list(range(100, 110))), 0, 0.5),
    (np.array([1, 1, 2, 2]), 2, 0.5),
    (np.array([], dtype=np.int64), 0, 0.5),
])
def test_query_freq_filter_cases(args):
    """tests/test_seedfilt.py's cases: under q_occ_max, a dominant hash,
    the filter off, the threshold; and an empty query."""
    same_freq(*args)


def test_the_port_is_a_copy():
    """The port's module is the JAX package's but for its docstring."""
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(REPO / "rawhash_tpu_torch/map/seedfilt.py") == body(
        REPO / "rawhash_tpu/map/seedfilt.py")
