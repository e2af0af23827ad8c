"""The control of the check at a cell's own size: the reference with TF32
on, put in the program's place, fails at least one of the cell's limits
where the job passes them all. Needs the card."""
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32 on the card")
    from benchmark import control, judge, run
    from isogs_slam_tpu_torch.ops import _cuda
    _cuda.build()
    check = run.cell_spec(cell)["check"]
    r = control.readings(cell, 20260001, torch.device("cuda"),
                         track_iters=check["track_iters_compared"])
    assert judge.verdict(r["sound"], check["limits"])
    assert not judge.verdict(r["control"], check["limits"])
