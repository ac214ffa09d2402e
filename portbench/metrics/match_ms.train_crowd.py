"""The greedy matching's device time a step in the crowd training window:
the seconds of the matching stage's kernels (K3; name patterns under the
stage ``match`` in ``kernels/match/*.json``) inside the traced window, over
the steps dispatched in it, in ms. The traced window opens and closes on a
synchronisation, so each of its steps ran wholly inside it."""

import json
from pathlib import Path

from portbench.metrics import layer

LAYER = "Loss, matching"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"

KERNELS = Path(__file__).resolve().parents[1] / "kernels" / "match"


def patterns() -> list[str]:
    out = []
    for path in sorted(KERNELS.glob("*.json")):
        out += json.loads(path.read_text())["stages"].get("match", [])
    return out


def read(bench):
    prof = layer._traced(bench)
    steps = bench.layer.get("steps")
    if prof is None or not steps:
        return None
    seconds = prof.kernel_seconds(patterns())
    if seconds <= 0:
        return None
    return 1e3 * seconds / steps
