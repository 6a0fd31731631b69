"""The comparison that decides `correct` tells a wrong program from a
right one, at a size the CPU holds.

- The control: the reference put in the program's place with its events
  stage computed in bfloat16, the precision below the configured float32,
  differs from the float32 reference on more sampled reads than the limit
  allows, while the port's records equal the reference's.
- Faults planted in the port's timed path, each of which the check must
  fail: a chunk step that hands back its state (the normalisation carry
  and the event offset) unchanged; half of each batch left out; an answer
  altered where it is produced.  The cells run on one card, so there is no
  exchange between cards to leave out.
"""

import pytest
import torch
from rhbench_small import run_small

from rhbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    result, compared, info = run_small(cell, reference_dtype=torch.bfloat16)
    assert result["correct"] is True
    assert compared["records_differ_share"]["value"] == 0.0
    control = info["control"]["records_differ_share"]
    assert control > 3 * run.LIMITS["records_differ_share"], control


def _state_unchanged(monkeypatch):
    import rawhash_tpu_torch.map.engine as eng

    step = eng.chunk_step

    def unchanged(didx, sig, slen, carry, ev_offset, *a, **k):
        return step(didx, sig, slen, carry, ev_offset, *a, **k)._replace(
            carry=carry, ev_offset=ev_offset)
    monkeypatch.setattr(eng, "chunk_step", unchanged)


def _half_left_out(monkeypatch):
    import rawhash_tpu_torch.map.engine as eng

    init = eng._BatchState.__init__

    def half(self, engine, reads, stream=None):
        init(self, engine, reads, stream)
        self.active[self.b // 2:] = False
    monkeypatch.setattr(eng._BatchState, "__init__", half)


def _answer_altered(monkeypatch):
    import rawhash_tpu_torch.map.engine as eng

    finalize = eng._finalize_batch

    def altered(engine, st):
        out = finalize(engine, st)
        for res in out:
            for m in res.records:
                if m.mapped:
                    m.frag_start += 1
        return out
    monkeypatch.setattr(eng, "_finalize_batch", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, compared, _ = run_small(CELLS[0])
    assert result["correct"] is False
    assert compared["records_differ_share"]["value"] > run.LIMITS["records_differ_share"]
