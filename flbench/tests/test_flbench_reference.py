"""The plain reference against the program, and the control.

At a tiny size on the CPU (8 clients, 20 samples each), a whole run of
each mix through ``flbench/run.py``'s ``execute`` comes out correct:
the reference's schedule equals the program's round for round and its
models are within the traffic's limits.  The control, the reference
computed in (emulated) TF32 in the program's place, comes out not
correct.  The card tests repeat both on a CUDA device.
"""

import time

import pytest
import torch

from flbench import control
from flbench.run import execute

CPU = torch.device("cpu")


def _run(root, cell, seed, device=CPU, replace=None):
    return execute(root, cell, seed, 1.0, False, device,
                   time.perf_counter(), replace=replace)


def _tf32(trainer, cell, inputs):
    control.ReferenceStep(trainer, cell["config"], cell["traffic"],
                          tf32=True)


@pytest.mark.parametrize("cell", ["tiny.sync", "tiny.async", "tiny.resnet"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_reference_agrees_with_the_program(tiny_root, cell, seed):
    res = _run(tiny_root, cell, seed)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["sched_mismatch"] == 0
    assert checks["init_gap"] == 0
    assert checks["rounds_checked"] >= 1
    assert res["correct"], checks


@pytest.mark.parametrize("cell", ["tiny.sync", "tiny.async"])
def test_float32_reference_in_the_programs_place_is_correct(tiny_root, cell):
    def f32(trainer, cell_, inputs):
        control.ReferenceStep(trainer, cell_["config"], cell_["traffic"],
                              tf32=False)
    res = _run(tiny_root, cell, 5, replace=f32)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny.sync", "tiny.async", "tiny.resnet"])
def test_lower_precision_fails(tiny_root, cell):
    res = _run(tiny_root, cell, 7, replace=_tf32)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tiny.sync", "tiny.async"])
def test_program_and_control_on_the_card(tiny_root, cuda_device, cell):
    assert _run(tiny_root, cell, 11, device=cuda_device)["correct"]
    assert not _run(tiny_root, cell, 11, device=cuda_device,
                    replace=_tf32)["correct"]
