"""The control comes out as not correct: the reference with its coupling
products in TF32 (float32 operands rounded to 10 mantissa bits, as the
tensor cores read them) in the program's place, judged against the
reference by the committed comparison and limits, on the CPU at a
test's size (on the card, at the cells' own sizes, ``readings.py``)."""
from __future__ import annotations

import pytest

from cardbench_util import tiny_cell
from cardbench.harness import check, problems as gen
from cardbench.reference.answers import answers as reference

SEED = 2**31 + 21


@pytest.mark.parametrize("name", ["chip64-anneal", "g22-sb"])
def test_the_tf32_control_is_not_correct(name):
    """The reference with TF32 products in the program's place, judged
    against the reference over two calls' runs by the committed limits."""
    cell = tiny_cell(name, control=True)
    mats = gen.make_problems(cell.config, cell.traffic, SEED)
    seeds = [SEED + 1, SEED + 2]
    got = reference(cell.config, cell.traffic, mats, seeds, "cpu",
                    tf32=True)
    want = reference(cell.config, cell.traffic, mats, seeds, "cpu")
    ok, shown = check.judged(check.compare(got, want, mats), cell.limits)
    assert not ok
    share = shown["energy_mismatch_share"]
    assert share["value"] > share["limit"]
