"""The quality gate's motion track on the card, held to JAX's colour
(BASELINE.md:208-213: MSE 0.103 against the 0.209 floor at 3000 steps,
every gate green). It is the test of the open fault "The motion gate is
red on the card" in ROADMAP.md §C, and fails on an H100 until that fault
is closed. Run on a machine with one NVIDIA GPU (about 3 min):

    python -m pytest tests/test_torch_quality_gate_card.py -q --noconftest

It skips without one (marker ``cuda``)."""

import json

import pytest
import torch

from t2ms_tpu_torch.cli import quality_gate

JAX_MOTION_MSE = 0.103       # BASELINE.md:208-213


@pytest.mark.cuda
def test_motion_gate_is_green_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rc = quality_gate.main(["--track", "motion", "--steps", "3000"])
    res = json.loads(capsys.readouterr().out)
    assert res["MSE"] <= 1.5 * JAX_MOTION_MSE, res
    assert all(res["gates"].values()), res
    assert rc == 0
