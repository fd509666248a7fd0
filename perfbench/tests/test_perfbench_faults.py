"""`correct` has to come out false for the control (the reference at the
next precision below the configuration's, put in the program's place)
and for each fault a cell can have, planted in the port underneath an
otherwise whole run."""
import pytest
import torch

from perfbench import control
from perfbench.tests import tiny_bench


@pytest.mark.parametrize("cell", sorted(tiny_bench.CELLS))
def test_control_fails_and_program_holds(tiny, cell):
    r = control.readings(tiny, cell, 2 ** 33 + 21, 1.0, "cpu")
    assert r["program"]["checked"] >= 1
    assert r["program"]["spike_mismatch"] == 0
    assert r["program"]["membrane_mismatch"] == 0
    assert r["control"]["spike_mismatch"] + \
        r["control"]["membrane_mismatch"] > 0


def _unchanged(out, V, keys):
    return (V, keys, torch.zeros_like(out[2])) + tuple(out[3:])


def _half_batch(out, V, keys):
    h = V.shape[0] // 2
    V2, s = out[0].clone(), out[2].clone()
    V2[h:], s[h:] = V[h:], False
    return (V2, out[1], s) + tuple(out[3:])


def _altered(out, V, keys):
    s = out[2].clone()
    s[:, 0] = ~s[:, 0]
    return (out[0], out[1], s) + tuple(out[3:])


STEP_FAULTS = {"unchanged_state": _unchanged, "half_batch": _half_batch,
               "altered_answer": _altered}
CASES = [(c, f) for c in sorted(tiny_bench.CELLS) for f in STEP_FAULTS] \
    + [("tiny_8core.lanes", "no_exchange")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_correct_false(tiny, monkeypatch, cell, fault):
    from repro_torch.core.engine import EventEngine
    from repro_torch.core.hiaer import HiAERNetwork
    if fault == "no_exchange":
        orig_x = HiAERNetwork._exchange

        def exchange(self, spikes_c, counts):
            nc, tr = orig_x(self, spikes_c, counts)
            return torch.zeros_like(nc), tr
        monkeypatch.setattr(HiAERNetwork, "_exchange", exchange)
    else:
        for cls in (EventEngine, HiAERNetwork):
            def step(self, V, keys, counts, _orig=cls._step,
                     _f=STEP_FAULTS[fault]):
                return _f(_orig(self, V, keys, counts), V, keys)
            monkeypatch.setattr(cls, "_step", step)
    res = tiny_bench.run_tiny(tiny, cell, 2 ** 33 + 31)
    assert res["checks"]["checked"]["value"] >= 1
    assert res["correct"] is False
