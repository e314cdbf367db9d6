"""The control, on the card at the cell's own size: the reference put in the
program's place with TF32 on (the precision below the configuration's
float32 with TF32 off) fails the check, while the program passes it on the
same sampled frames. `python -m pytest slambench/tests -m cuda` on the card."""
import time

import pytest

from slambench import check, spec
from slambench.run import measure, reference_rows

SEEDS = [2**31 + 301, 2**31 + 302, 2**31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", ["tum_mono_direct.replay"])
def test_tf32_control_fails_where_the_program_passes(cell_name, seed, cuda_device):
    cell = spec.load_cell(cell_name)
    m = measure(cell, seed, 2.0, False, cuda_device, time.perf_counter())
    program = reference_rows(m, cell, cuda_device)
    control = reference_rows(m, cell, cuda_device, tf32=True)
    summarize = cell.reference.summarize
    ok, table = check.judge(summarize(program), len(program), m.sampled, cell.limits)
    assert ok, table
    ok, table = check.judge(summarize(control), len(control), m.sampled, cell.limits)
    assert not ok, table
