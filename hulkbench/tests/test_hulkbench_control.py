"""The control (the reference's weighted sampling in float32, in the
program's place) comes out not correct, at a tiny size; on the chip it is
run at each cell's own size with `python3 -m hulkbench.control`."""
from __future__ import annotations

import pytest


@pytest.mark.parametrize("cell", ["reads-k21.samples", "reads-k21.stream-drift"])
def test_the_float32_control_fails_the_comparison(cell, caches, tiny, workdir):
    from hulkbench.control import readings

    checks = readings(tiny(cell), 2**31 + 5, "cpu", workdir)
    assert checks["weights_mismatched"]["value"] > checks["weights_mismatched"]["limit"]
