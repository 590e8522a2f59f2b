"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (inputs, warm-up, window, reference, comparison) at a
tiny size on the CPU, once for each fault a cell can have. One chip a cell,
so there is no exchange between chips to leave out."""
from __future__ import annotations

import numpy as np
import pytest

CELLS = ["reads-k21.samples", "reads-k21.stream-drift"]


def _run(tiny, name, workdir):
    from hulkbench.run import run_cell

    return run_cell(tiny(name), 2**31 + 11, 0, False, device="cpu", workdir=workdir)


def _unchanged_state(monkeypatch):
    """The flush returns with the sketch as it was."""
    from hulk_tpu_torch.sketch import histosketch

    monkeypatch.setattr(histosketch.HistoSketch, "add_elements", lambda self, b, f: None)


def _half_batch(monkeypatch):
    """Half of every batch of records left out of the device step."""
    from hulk_tpu_torch.stream import pipeline

    feed = pipeline._DeviceStream.feed

    def half(self, batch):
        n = batch.lengths.shape[0]
        lengths = batch.lengths.copy()
        lengths[n // 2:] = 0
        batch.lengths = lengths
        return feed(self, batch)

    monkeypatch.setattr(pipeline._DeviceStream, "feed", half)


def _altered_answer(monkeypatch):
    """One weight of each document moved by one ulp where it is written."""
    from hulk_tpu_torch.io import sketchio

    sketch_json = sketchio.HULKData._sketch_json

    def altered(self, algo, s):
        out = sketch_json(self, algo, s)
        if algo == "histosketch":
            out["weights"][0] = float(np.nextafter(out["weights"][0], 0.0))
        return out

    monkeypatch.setattr(sketchio.HULKData, "_sketch_json", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_comes_out_correct(cell, caches, tiny, workdir):
    res = _run(tiny, cell, workdir)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_comes_out_not_correct(cell, fault, caches, tiny, workdir, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(tiny, cell, workdir)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values()) or res["errors"]
