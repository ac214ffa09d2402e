"""The device trace of a run's window (``--trace 1``), read into what the
per-layer metrics and the ``breakdown`` need.

``torch.profiler`` records the device's kernels, copies and sets through
CUPTI, graph replays included, and the host's operations; a
``record_function`` range marks the window, so the device times and the
window are on one clock.
"""

from __future__ import annotations

import re
import time

WINDOW = "portbench.window"
# The traced part of a window, from its start: the profiler's own
# processing grows with the events, about ten seconds a traced second of
# the training cells, and a traced run has to end within its time limit.
TRACE_S = 4.0


class Profile:
    """The profiler, started in set-up (``start``), the window marked on
    its clock (``open``, ``close``) and its events read at ``stop``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.device = []     # (name, start_us, end_us) of device activity
        self.host = []       # (name, start_us, end_us) of host operations
        self.window = None   # (start_us, end_us)

    def start(self) -> "Profile":
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def open(self) -> None:
        self.opened = time.monotonic()
        if self.enabled:
            from torch.profiler import record_function

            self._mark = record_function(WINDOW)
            self._mark.__enter__()

    def close(self) -> None:
        self.closed = time.monotonic()
        if self.enabled:
            self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        if not self.enabled:
            return
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        # the raw events: parsing them into FunctionEvents costs minutes
        # for a window of a few hundred thousand launches
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            rng = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
            if e.device_type() == DeviceType.CUDA:
                # a range marked on the host shows on the device's
                # timeline too; it is no device work
                if not (name == WINDOW or e.is_user_annotation()):
                    self.device.append(rng)
            elif name == WINDOW:
                self.window = rng[1:]
            else:
                self.host.append(rng)
        self._prof = None

    # -- readings --
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran (the
        union of the intervals)."""
        return sum(b - a for a, b in self._union()) / 1e6

    def _inside(self):
        """The device activities, each clipped to the window."""
        lo, hi = self.window
        return [(name, max(a, lo), min(b, hi)) for name, a, b in self.device
                if b > lo and a < hi]

    def _union(self) -> list:
        spans = sorted((a, b) for _, a, b in self._inside())
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_seconds(self, patterns: list[str]) -> float:
        """Device seconds in the window of the activities whose name
        matches one of ``patterns`` (regular expressions, searched)."""
        regs = [re.compile(p) for p in patterns]
        return sum(b - a for name, a, b in self._inside()
                   if any(r.search(name) for r in regs)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        total: dict[str, float] = {}
        for name, a, b in self._inside():
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in total.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle stretches of the device in the window,
        each named by the host operation that was running when it began
        (the innermost one that spans its start)."""
        busy = self._union()
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for a, b in gaps:
            inner = [(e - s, n) for n, s, e in self.host if s <= a < e]
            name = min(inner)[1] if inner else "host idle"
            out.append([name, (b - a) / 1e6])
        return out
