"""The arithmetic the per-layer readers share. A reader that finds
nothing to read returns None, never 0."""

from __future__ import annotations

import json
from pathlib import Path

from portbench import counts

KERNELS = Path(__file__).resolve().parents[1] / "kernels"
ADAM_OPS = 15   # a parameter's share of the global norm, clipping and Adam


def stage_patterns(stage: str) -> list[str]:
    """Name patterns of a stage's kernels, from every implementation's
    file in ``kernels/``."""
    out = []
    for path in sorted(KERNELS.glob("*.json")):
        out += json.loads(path.read_text())["stages"].get(stage, [])
    return out


def _traced(bench):
    prof = bench.profile
    if prof is None or not prof.window or prof.window_s <= 0:
        return None
    return prof


def device_idle(bench):
    prof = _traced(bench)
    if prof is None:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)


def pair_roofline(bench, stage: str):
    """Least time of the window's pair-stage work over the device time of
    that stage's kernels, in percent."""
    prof, work = _traced(bench), bench.layer
    if prof is None or not work.get("pairs"):
        return None
    seconds = prof.kernel_seconds(stage_patterns(stage))
    if seconds <= 0:
        return None
    model = work["model"]
    p, blocks = model["pairwise_dim"], model["num_blocks"]
    flops = work["pairs"] * blocks * counts.pair_flops(p)
    rows = work["dets"] * blocks
    nbytes = (counts.pair_forward_bytes(p, rows, work["launches"])
              if stage == "pair_fwd" else
              counts.pair_backward_bytes(p, rows, work["launches"]))
    return 100.0 * counts.least_seconds(flops, nbytes) / seconds


def forward_flops(work: dict) -> int:
    return counts.forward_flops(work["model"], work["dets"], work["pairs"])


def mfu(bench, training: bool):
    """The window's needed operations over the window at the bf16 peak,
    in percent: the forward, for training also the backward (twice the
    forward) and the optimizer."""
    prof, work = _traced(bench), bench.layer
    if prof is None or not work.get("dets"):
        return None
    flops = forward_flops(work)
    if training:
        flops = 3 * flops + ADAM_OPS * work["params"] * work["steps"]
    return 100.0 * flops / (prof.window_s * counts.PEAKS["bf16_flops"])


def images_per_batch(bench):
    served = bench.layer.get("server")
    if not served or not served.get("batches"):
        return None
    return served["images"] / served["batches"]


def capture_seconds(bench):
    value = bench.layer.get("capture_s")
    return value if value else None
