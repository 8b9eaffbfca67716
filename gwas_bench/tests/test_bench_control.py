"""The control: the plain reference put in the program's place and
computed in TF32 (the next precision below the configuration's float32
with TF32 off) has to come out not correct, for every cell; the program
itself comes out correct.  At a test's size on the CPU; on the card at
the cells' own sizes, ``gwas_bench/control.py`` gives the readings."""

import pytest
import torch

from conftest import CELLS, SEED
from gwas_bench import control, judge

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_refused(small_cell, name):
    cell = small_cell(name)
    for seed in (SEED, SEED + 1):
        numbers = control.control_readings(cell, seed, CPU, "tf32")
        assert not judge.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(small_cell, name):
    cell = small_cell(name)
    numbers = control.program_readings(cell, SEED, CPU)
    assert judge.verdict(numbers, cell.limits), numbers
