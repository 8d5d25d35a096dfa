"""The port's profiling helpers (awm_tpu_torch/utils/profiling.py): StepTimer
against the JAX package's on the same clock ticks, trace() writing a trace
on the CPU, and debug_nan_mode() raising on a NaN in forward and in
backward and restoring autograd's anomaly mode."""

import json
import os

import pytest
import torch

from awm_tpu.utils import profiling as jprof

from awm_tpu_torch.utils import profiling


def _ticks(monkeypatch, module, times, clips):
    it = iter(times)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))
    timer = module.StepTimer(window=3)
    readings = []
    for c in clips:
        timer.tick(c)
        readings.append((timer.steps_per_sec, timer.clips_per_sec, timer.ms_per_step))
    return readings


def test_step_timer_matches_jax(monkeypatch):
    """Every reading after every tick, through the window's roll-over and a
    zero-length span, equal to the JAX StepTimer's."""
    times = [10.0, 10.5, 10.75, 11.5, 12.0, 12.0, 13.25]
    clips = [0, 8, 8, 16, 8, 4, 8]
    got = _ticks(monkeypatch, profiling, times, clips)
    ref = _ticks(monkeypatch, jprof, times, clips)
    assert str(got) == str(ref)  # equal, NaN included
    assert got[0] == (0.0, 0.0, got[0][2]) and got[3][0] == pytest.approx(2.0)


def test_trace_writes_a_trace(tmp_path):
    lin = torch.nn.Linear(8, 8)
    with profiling.trace(str(tmp_path / "t"), host=True) as prof:
        lin(torch.ones(4, 8)).sum().backward()
    assert prof.key_averages()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") for e in events)


def test_debug_nan_mode_raises_and_restores():
    lin = torch.nn.Linear(3, 3)
    x = torch.ones(2, 3)
    x[0, 0] = float("nan")
    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="Linear"):
        with profiling.debug_nan_mode():
            lin(x)
    assert not torch.is_anomaly_enabled()
    w = torch.zeros(1, requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan"):
        with profiling.debug_nan_mode():
            (torch.sqrt(w) * 0.0).sum().backward()  # finite forward, 0 * inf in backward
    assert not torch.is_anomaly_enabled()
    with profiling.debug_nan_mode():  # a finite step passes, and the hook goes on exit
        lin(torch.ones(2, 3)).sum().backward()
    lin(x)
    torch.autograd.set_detect_anomaly(True)
    try:
        with profiling.debug_nan_mode():
            pass
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
