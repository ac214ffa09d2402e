"""The arithmetic of the multi-class cell's readers: ``layer.py``'s, with
the class-aware model's work (``counts_multiclass.py``), and K3's device
time. A reader that finds nothing to read returns None, never 0."""

from __future__ import annotations

import json

from portbench import counts, counts_multiclass
from portbench.metrics import layer


def pair_roofline(bench, stage: str):
    """Least time of the window's class-aware pair-stage work over the
    device time of that stage's kernels, in percent."""
    prof, work = layer._traced(bench), bench.layer
    if prof is None or not work.get("pairs"):
        return None
    seconds = prof.kernel_seconds(layer.stage_patterns(stage))
    if seconds <= 0:
        return None
    model = work["model"]
    p, blocks = model["pairwise_dim"], model["num_blocks"]
    flops = work["pairs"] * blocks * counts_multiclass.pair_flops(p)
    rows = work["dets"] * blocks
    nbytes = (counts_multiclass.pair_forward_bytes(p, rows, work["launches"])
              if stage == "pair_fwd" else
              counts_multiclass.pair_backward_bytes(p, rows,
                                                    work["launches"]))
    return 100.0 * counts.least_seconds(flops, nbytes) / seconds


def mfu(bench):
    """The window's needed operations of a class-aware training step (the
    forward, a backward of twice it and the optimizer) over the window at
    the bf16 peak, in percent."""
    prof, work = layer._traced(bench), bench.layer
    if prof is None or not work.get("dets"):
        return None
    flops = (3 * counts_multiclass.forward_flops(work["model"], work["dets"],
                                                 work["pairs"])
             + layer.ADAM_OPS * work["params"] * work["steps"])
    return 100.0 * flops / (prof.window_s * counts.PEAKS["bf16_flops"])


def match_patterns() -> list[str]:
    """Name patterns of the matching stage's kernels
    (``kernels/match/*.json``)."""
    out = []
    for path in sorted((layer.KERNELS / "match").glob("*.json")):
        out += json.loads(path.read_text())["stages"].get("match", [])
    return out


def match_seconds(bench):
    """K3's device seconds in the traced window, or None without any."""
    prof = layer._traced(bench)
    if prof is None:
        return None
    seconds = prof.kernel_seconds(match_patterns())
    return seconds if seconds > 0 else None
