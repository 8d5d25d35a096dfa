"""Tracing and profiling helpers (counterpart of awm_tpu/utils/profiling.py).

- StepTimer: rolling step-time and clips/s counters for training loops.
- trace(): context manager around torch.profiler that writes a Chrome /
  Perfetto trace of the host and the card into log_dir.
- debug_nan_mode(): raise FloatingPointError at the first non-finite module
  output in forward, and at the first NaN gradient in backward (the
  counterpart of jax_debug_nans).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque

import torch


class StepTimer:
    """Rolling window step timer: call tick(batch_clips) once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: Deque[float] = deque(maxlen=window + 1)
        self._clips: Deque[int] = deque(maxlen=window)

    def tick(self, clips: int = 0) -> None:
        self._times.append(time.perf_counter())
        self._clips.append(clips)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0

    @property
    def clips_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        n = sum(list(self._clips)[-(len(self._times) - 1):])
        return n / span if span > 0 else 0.0

    @property
    def ms_per_step(self) -> float:
        sps = self.steps_per_sec
        return 1000.0 / sps if sps > 0 else float("nan")


@contextlib.contextmanager
def trace(log_dir: str, *, host: bool = False):
    """Profile the host and, where there is one, the card while the context
    runs, and write the trace as trace.json into log_dir (open it in
    Perfetto or chrome://tracing).  host=True also records tensor shapes and
    Python stacks.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=host, with_stack=host) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _finite_or_raise(module, _inputs, output):
    outs = output if isinstance(output, (tuple, list)) else (output,)
    for t in outs:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and not torch.isfinite(t).all():
            raise FloatingPointError(f"non-finite output of {type(module).__name__}")


@contextlib.contextmanager
def debug_nan_mode():
    """Within the context, the first non-finite output of any module's
    forward raises FloatingPointError (a forward hook on every module), and
    so does the first backward function that returns a NaN gradient
    (autograd's anomaly mode, whose RuntimeError is re-raised as
    FloatingPointError).  The hooks are removed and the anomaly mode is
    restored on exit.  A training debug aid: every check syncs with the
    card."""
    handle = torch.nn.modules.module.register_module_forward_hook(_finite_or_raise)
    prev, prev_check = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    except RuntimeError as e:
        if "nan" in str(e).lower():
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_check)
        handle.remove()
