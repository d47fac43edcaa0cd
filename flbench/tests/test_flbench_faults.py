"""Planted faults under a run (``flbench/control.py: FAULTS``): each
must come out not correct.

The harness is driven on the CPU past its look for a card, with the
timed path broken underneath: a step that leaves the model unchanged;
half of a cohort left out of the merge, the mean taken over the rest;
an answer altered where it is produced (the merged model, the reported
accuracy).  One card holds a cell, so no exchange between cards can be
left out.
"""

import time

import pytest
import torch

from flbench.control import FAULTS
from flbench.run import execute


@pytest.mark.parametrize("cell", ["tiny.sync", "tiny.async"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    def replace(trainer, cell_, inputs):
        FAULTS[fault](trainer, cell_, inputs, monkeypatch.setattr)
    res = execute(tiny_root, cell, 13, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), replace=replace)
    assert not res["correct"], res["checks"]
