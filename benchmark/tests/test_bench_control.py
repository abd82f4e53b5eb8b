"""The control of each cell on a card, at a narrow width: the reference
computed in TF32 (`reference/precision.py`), the precision below the
configurations' float32, put in the program's place, fails at least one of
the cell's numbers against the limits in its mix; a sound run of the
program passes them. On the chip at the cells' own sizes this is
`python -m benchmark.control`."""

import pytest

from benchmark.run import generator_of
from benchmark.tests.tiny import tiny_cell

CELLS = ["v1.train", "v2.offline"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name, card):
    cell, cfg = tiny_cell(name)
    if name != "v1.train":  # the inference cell at the dataset's 75 joints
        J = 75
        cfg["dataset"].update(njoints=J, pose_input_size=6 + J * 15 + 3,
                              pose_output_size=6 + J * 15)
    run = generator_of(cell).Run(cell, cfg, 2**31 + 5, card)
    run.setup()
    run.window(1.0)
    run.release()
    try:
        checks = run.check()
        control = run.control()
    finally:
        run.close()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert any(control[k] > c["limit"] for k, c in checks.items()), (control, checks)
