"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16 fails the comparison that the program, run
in the float32 the configuration states, passes; on the CPU at the tiny
size, and on the card at the bicycle cell's own size."""

import json

import pytest
import torch

from benchmark import check, control, registry
from benchmark.tests import tiny


def limits(root=None):
    reg = registry.Registry(root or registry.ROOT)
    return reg.traffic("span")["limits"]


def test_bf16_control_fails_where_the_float32_program_passes(tmp_path):
    root = tiny.make_root(tmp_path, dtype="float32")
    lim = limits(root)
    sound = control.readings(tiny.CELL, [0, 1], "none", device="cpu", root=root)
    low = control.readings(tiny.CELL, [0, 1], "bf16", device="cpu", root=root)
    assert all(check.within(r, lim) for r in sound), json.dumps(sound)
    assert not any(check.within(r, lim) for r in low), json.dumps(low)


@pytest.mark.cuda
def test_bf16_control_fails_at_the_cell_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lim = limits()
    sound = control.readings("bicycle.span", [0], "none")
    low = control.readings("bicycle.span", [0], "bf16")
    assert check.within(sound[0], lim), json.dumps(sound)
    assert not check.within(low[0], lim), json.dumps(low)
