"""The control and a sound run of the tiny cell on the card: the sound
run must be correct and the control not. Skips without a CUDA device;
run it on the card with `python -m pytest qbench/tests -m cuda`."""

from __future__ import annotations

import pytest
import torch

from conftest import run_main


@pytest.mark.cuda
@pytest.mark.parametrize("control, expect", [(0, True), (1, False)])
def test_control_on_card(tiny, control, expect):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rc, res, err = run_main(tiny, ["--workload", "tiny.stream", "--seed",
                                   str(7 + control), "--seconds", "2",
                                   "--trace", "0", "--control",
                                   str(control)], device="cuda")
    assert rc == 0, err[-3000:]
    assert res["correct"] is expect, err[-3000:]
