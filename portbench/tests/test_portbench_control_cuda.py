"""The control at each cell's own size, on the card: on three seeds the
program's numbers stay within the cell's limits and the control, the
reference in float32 with TF32 products put in the program's place, fails
at least one. Skips where torch finds no CUDA device."""

import pytest

from portbench import cell as cells, readings

CELLS = ["deit_small_w4a4.serve_b200", "swin_base_w4a4.serve_b200",
         "deit_small_w4a4.serve_int8_b200"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [901, 902, 903])
def test_control_fails_at_size(card, name, seed):
    cell = cells.load(name)
    got = readings.read_seed(cell, seed, card)
    limits = cell["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got
