"""The program's own spans in a traced window: the ``gossipnet.*`` ranges
that ``gossipnet_tpu_torch.utils.profiling.span`` records while the
profiler runs, on the device trace's clock (``Profile.host``). A reading
finds nothing, and returns None, in a program that records no spans."""

from __future__ import annotations

import statistics

PREFIX = "gossipnet."
STEP = "gossipnet.train.step"
LAUNCH = "gossipnet.graphs.launch"
# A step's time that is not the trainer's own host work: the replay's
# launch, a capture and the log's wait for the device.
NOT_HOST = ("gossipnet.graphs.launch", "gossipnet.graphs.capture",
            "gossipnet.train.sync")
OUTSIDE = "outside every span"


def window_spans(prof) -> list:
    """The program's spans that lie wholly inside the window, as (name,
    start_us, end_us)."""
    if prof is None or not prof.window:
        return []
    lo, hi = prof.window
    return [s for s in prof.host
            if s[0].startswith(PREFIX) and lo <= s[1] and s[2] <= hi]


def _covered(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def self_ms(span, spans, less=NOT_HOST) -> float:
    """The span's duration less what its descendants named in ``less``
    cover, in ms."""
    _, a, b = span
    inner = [(s, e) for n, s, e in spans
             if n in less and a <= s and e <= b and (n, s, e) != span]
    return (b - a - _covered(inner)) / 1e3


def _median(values):
    return statistics.median(values) if values else None


def step_host_ms(bench):
    """Median over the window's step spans of a step's host self time:
    the step less its launches, captures and syncs."""
    spans = window_spans(bench.profile)
    return _median([self_ms(s, spans) for s in spans if s[0] == STEP])


def launch_ms(bench):
    """Median duration of the window's graph launches, in ms."""
    return _median([(e - s) / 1e3 for n, s, e in window_spans(bench.profile)
                    if n == LAUNCH])


def idle_by_span(prof) -> dict:
    """Each span name's share of the window's idle device time, by the
    innermost span that holds the start of each idle stretch; what starts
    outside every span is under :data:`OUTSIDE`. Empty without a trace or
    with no idle time."""
    spans = window_spans(prof)
    if prof is None or not prof.window:
        return {}
    lo, hi = prof.window
    gaps, t = [], lo
    for a, b in prof._union():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return {}
    out: dict[str, float] = {}
    for a, b in gaps:
        inner = [(e - s, n) for n, s, e in spans if s <= a < e]
        name = min(inner)[1] if inner else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a) / total
    return dict(sorted(out.items(), key=lambda x: -x[1]))
