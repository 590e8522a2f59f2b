"""Backend-stall watchdog of the port (hulk_tpu_torch/stream/watchdog.py),
the counterparts of tests/test_watchdog.py's cases that the port keeps
(it has no re-exec, no retries and no knobs).

The stall is simulated by a probe or an op that never completes; the
watchdog's two outcomes are asserted: pass-through and a clean abort,
never a hang. The CLI case runs on a synthetic FASTQ file with the card
pretended present.
"""
import logging
import os
import threading
import time

import pytest

import hulk_tpu_torch.cli as torch_cli
from hulk_tpu_torch.stream import watchdog as wd
from hulk_tpu_torch.synth import generate


def _stalled_probe(timeout_s, **kw):
    """A probe that 'times out' immediately (simulated hang)."""
    return False, timeout_s


def _ok_probe(timeout_s, **kw):
    return True, 0.01


def test_probe_completes_fast_op():
    ok, dt = wd.probe_device_roundtrip(30.0, _op=lambda: None)
    assert ok and dt < 5.0


def test_probe_round_trip_on_the_cpu():
    """The default op: 16 elements to the device and back."""
    ok, dt = wd.probe_device_roundtrip(30.0, device="cpu")
    assert ok and dt < 5.0
    assert not wd.unsafe_teardown()


def test_probe_times_out_on_stalled_op():
    hang = threading.Event()
    t0 = time.monotonic()
    ok, dt = wd.probe_device_roundtrip(0.2, _op=hang.wait)
    assert not ok
    assert 0.15 <= time.monotonic() - t0 < 5.0
    hang.set()  # release the abandoned daemon thread


def test_probe_propagates_real_errors():
    def boom():
        raise RuntimeError("device says no")

    with pytest.raises(RuntimeError, match="device says no"):
        wd.probe_device_roundtrip(5.0, _op=boom)


@pytest.mark.parametrize("device,card", [("cpu", True), ("cuda", False)])
def test_ensure_noop_without_a_card(monkeypatch, device, card):
    """Nothing to probe on the CPU, nor for cuda when no card is visible
    (the pipeline then fails with its own message)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: card)
    monkeypatch.setattr(wd, "probe_device_roundtrip",
                        lambda *a, **kw: pytest.fail("must not probe"))
    wd.ensure_backend_alive(device=device)


def test_ensure_passes_on_healthy_backend():
    wd.ensure_backend_alive(_probe=_ok_probe)


def test_ensure_aborts_on_stall():
    """A stall raises at once, naming the device and the deadline."""
    with pytest.raises(wd.BackendStallError, match=r"stalled: .* in 75s \(device=cuda"):
        wd.ensure_backend_alive(_probe=_stalled_probe)


def test_guard_backend_exits_on_stall(monkeypatch, caplog):
    """guard_backend turns a stall into the reference's fatal: ERROR---> in
    the log and exit status 1."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr(wd, "probe_device_roundtrip", _stalled_probe)
    logger = logging.getLogger("test_torch_watchdog")
    with caplog.at_level(logging.ERROR, logger=logger.name), \
            pytest.raises(SystemExit) as ei:
        wd.guard_backend(logger, device="cuda")
    assert ei.value.code == 1
    assert "ERROR---> device backend stalled" in caplog.text


def test_cli_sketch_aborts_cleanly_on_simulated_stall(monkeypatch, tmp_path, capsys):
    """End-to-end: a stalled card fails `sketch` with the reference fatal
    policy (ERROR---> + exit 1) instead of hanging, and writes nothing."""
    fq = generate(str(tmp_path / "reads.fq.gz"), 200, read_len=150, seed=41)
    # the watchdog skips a run with no card; pretend there is one, with a
    # hung data path
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr(wd, "probe_device_roundtrip", _stalled_probe)
    out = str(tmp_path / "wd")
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["sketch", "-f", fq, "-k", "11", "-w", "5", "-o", out])
    assert ei.value.code == 1
    assert not os.path.exists(out + ".json")
    err = capsys.readouterr()
    assert "stalled" in err.err or "stalled" in err.out
