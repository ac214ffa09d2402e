"""Profiling hooks (port of ``gossipnet_tpu/utils/profiling.py``) on
``torch.profiler``.

A ``--profile DIR`` training run writes a trace of a window of steps
(:class:`StepProfiler`, steps 10-15 as in the reference) to
``DIR/trace.json`` in the Chrome trace format (chrome://tracing,
Perfetto). The trace holds the host's operator calls and, on the card,
every kernel, those that captured graphs replay included.

:func:`span` marks the trainer's and the graphs' own host work by name
(``gossipnet.train.step``, ``gossipnet.graphs.launch`` ...). While a
profiler records, a span is a ``torch.profiler.record_function`` range in
the same trace as the device's kernels, so both share one clock; the
spans stay in the profiler's memory until whoever stopped it writes or
reads its events. With no profiler recording, a span is one flag read and
a shared no-op context.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

TRACE_FILE = "trace.json"

# What span() returns while no profiler records: reusable, and nesting.
OFF = contextlib.nullcontext()


def span(name: str):
    """A named host range for the profiler's trace, or :data:`OFF` when no
    profiler is recording (``torch.profiler.profile`` sets the flag read
    here on entering and clears it on leaving)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return OFF


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


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
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.start()
            self._active = True
        elif step >= self.stop and self._active:
            self.close()

    def close(self) -> None:
        if not self._active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()      # the window's device work, all of it
        self.prof.stop()
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(Path(self.log_dir) / TRACE_FILE))
        self._active = False
