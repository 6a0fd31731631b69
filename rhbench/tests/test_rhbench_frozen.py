"""The benchmark's frozen copies equal the port's functions today, at a
small size: the traffic generator and K1's bound arithmetic.  A failure
here means the port's function moved; the benchmark keeps its own."""

import numpy as np
import pytest
import torch

from rhbench import bounds, gen


def test_random_genome_equals_port():
    from rawhash_tpu_torch.synthetic import random_genome

    for seed in (0, 7, 2**31 + 5):
        assert gen.random_genome(5000, np.random.default_rng(seed)) == \
            random_genome(5000, np.random.default_rng(seed))


@pytest.mark.parametrize("k", [5, 6])
def test_synthetic_pore_equals_port(k):
    from rawhash_tpu_torch.pore import synthetic_pore

    ours, port = gen.synthetic_pore(k=k), synthetic_pore(k=k)
    assert ours.k == port.k
    np.testing.assert_array_equal(ours.pore_vals, port.pore_vals)


@pytest.mark.parametrize("strand", [0, 1])
def test_seq_to_sig_equals_port(strand):
    from rawhash_tpu_torch.pore import PoreModel, seq_to_sig

    pore = gen.synthetic_pore()
    seq = gen.random_genome(3000, np.random.default_rng(3)) + "NACGTN" + "ACGT" * 20
    ours = gen.seq_to_sig(seq, pore, strand)
    port = seq_to_sig(seq, PoreModel(pore.k, pore.pore_vals), strand)
    np.testing.assert_array_equal(ours, port)


def test_simulate_reads_equal_port():
    from rawhash_tpu_torch.io.signal_gen import simulate_read, simulate_reads
    from rawhash_tpu_torch.pore import PoreModel

    pore = gen.synthetic_pore()
    port_pore = PoreModel(pore.k, pore.pore_vals)
    genome = gen.random_genome(20000, np.random.default_rng(1))
    ours = gen.simulate_reads(genome, pore, 6, 800, np.random.default_rng(9))
    port = simulate_reads(genome, port_pore, 6, 800, np.random.default_rng(9))
    for a, b in zip(ours, port):
        assert a[0] == b[0] and a[2:] == b[2:]
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(
        gen.simulate_read(genome, pore, 100, 500, 1, np.random.default_rng(4)),
        simulate_read(genome, port_pore, 100, 500, 1, np.random.default_rng(4)))


def _fill_inputs(seed, b=6, n=300):
    from rawhash_tpu_torch.synthetic import clustered_anchors

    key, tpos, qpos, n_anchors = clustered_anchors(seed, b, n)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (key, tpos, qpos, n_anchors))


@pytest.mark.parametrize("preset", ["viral", "sensitive"])
def test_fill_bound_equals_port(preset):
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.profiling import bounds as port
    from rawhash_tpu_torch.synthetic import options

    iopt, mopt = options(preset)
    prm = fill_params(iopt, mopt)
    args = _fill_inputs(11)
    ours, theirs = bounds.fill_work(*args, **prm), port.fill_work(*args, **prm)
    assert ours == theirs and ours["in_band"] > 0
    assert bounds.fill_ops(ours) == port.fill_ops(theirs)
    assert bounds.FILL_COST == port.FILL_COST
    assert (bounds.HBM_BYTES_PER_S, bounds.SMS, bounds.PER_SM_PER_CLOCK, bounds.BOOST_HZ) == \
        (port.HBM_BYTES_PER_S, port.SMS, port.PER_SM_PER_CLOCK, port.BOOST_HZ)
    ops = bounds.fill_ops(ours)
    assert bounds.bound(1e6, **ops) == port.bound(1e6, **ops)
