"""Profiling hooks (port of ``gossipnet_tpu/utils/profiling.py``) on
``torch.profiler`` and ``torch.cuda.memory_stats``.

A ``--profile DIR`` training run writes a trace of a window of steps
(:class:`StepProfiler`, steps 10-15 as in the reference) to
``DIR/trace.json`` in the Chrome trace format (chrome://tracing,
Perfetto); :func:`profile_trace` traces any block of code. The trace holds
the host's operator calls and, on the card, every kernel, those that
captured graphs replay included. :func:`kernel_ms` sums a trace's kernel
time by name: the device-busy share of a window is its sum over the
window's wall time.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start() -> torch.profiler.profile:
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, log_dir: str | Path | None) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()      # the window's device work, all of it
    prof.stop()
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None, enabled: bool = True):
    """Trace the block -> yields the profiler (None when disabled). The
    trace is written to ``log_dir/trace.json`` when ``log_dir`` is given;
    the card's work is synchronised before the trace ends."""
    if not enabled:
        yield None
        return
    prof = _start()
    try:
        yield prof
    finally:
        _stop(prof, log_dir)


class StepProfiler:
    """Profiles steps [start, stop) of a training loop into
    ``log_dir/trace.json``; ``prof`` holds the finished profile."""

    def __init__(self, log_dir: str | Path, start: int = 10, stop: int = 15,
                 enabled: bool = False):
        self.log_dir = str(log_dir)
        self.start, self.stop = start, stop
        self.enabled = enabled
        self.prof = None
        self._active = False

    def step(self, step: int) -> None:
        if not self.enabled:
            return
        if step == self.start and not self._active:
            self.prof = _start()
            self._active = True
        elif step >= self.stop and self._active:
            self.close()

    def close(self) -> None:
        if self._active:
            _stop(self.prof, self.log_dir)
            self._active = False


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


def kernel_ms(prof) -> dict[str, float]:
    """Device time of a finished profile by kernel name, ms in all. Kernel
    events only: a user annotation (an optimizer's step range) also
    carries device time, spanning the kernels inside it."""
    from torch.autograd import DeviceType

    return {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key}


def device_memory_stats() -> dict:
    """Memory of each CUDA device, bytes: in use, the peak, reserved by
    the caching allocator (captured graphs' pools included) and the
    card's total. Empty without a card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
