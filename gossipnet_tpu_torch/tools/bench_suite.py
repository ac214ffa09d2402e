"""The extended benchmark: N scaling, layouts, sparse against dense tiles
(the port's counterpart of ``scripts/bench_suite.py``).

    python -m gossipnet_tpu_torch.tools.bench_suite [--device cpu]

The reference's eleven cases of the 16-block flagship model with seeded
weights: N=1024 B=8 and N=4096 B=2, each in the ``clustered`` (the best
case for the tile skip), ``uniform`` (COCO-like spread), ``mixed``
(crowded foreground over scattered background) and ``blob`` (all boxes
overlapping in one region, most pairs neighbours: the adversarial worst
case) layouts with the tile skip on, and
each with ``dense-tiles`` (no tile skip, no sort); and N=256 B=16
clustered. Each is measured as ``tools/bench.py`` measures, with chain
lengths 10 and 40, best of three. It prints one line per case as it goes,
then one JSON line of all of them (``ms_per_fwd``, ``dets_per_sec``,
``B``, ``N``, ``layout`` and the ``card`` each ran on), then ``DONE``.

``--device cpu`` runs each case at B=1 on the dense plain path with
chain lengths 2 and 6 (``tools/bench.py``'s leg for the CPU); the N=4096
cases take minutes each there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.tools.bench import (
    Chain,
    card_line,
    forward_step,
    layout_arrays,
    marginal_seconds,
)
from gossipnet_tpu_torch.tools.entry import (
    device_tensors,
    flagship_cfg,
    seeded_model,
)

LOOPS = (10, 40)   # the two chain lengths on the card


def cases() -> list[tuple[str, dict, int, int, str]]:
    """(name, model overrides, B, N, layout) of every case
    (``scripts/bench_suite.py:46-52``)."""
    out = []
    for n, b in ((1024, 8), (4096, 2)):
        for layout in ("clustered", "uniform", "mixed", "blob"):
            out.append((f"N={n} {layout} sparse", {}, b, n, layout))
        out.append((f"N={n} dense-tiles",
                    dict(block_sparse=False, sort_detections=False), b, n,
                    "clustered"))
    out.append(("N=256 clustered sparse", {}, 16, 256, "clustered"))
    return out


def main(argv=None) -> dict:
    """Runs every case -> {name: result}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = card_line(device)
    rng = np.random.default_rng(7)
    flag = flagship_cfg()
    results = {}
    for name, overrides, b, n, layout in cases():
        b = b if on_card else 1
        cfg = Config(model=dataclasses.replace(flag.model, **overrides))
        model = seeded_model(cfg, device)
        boxes, scores, valid = device_tensors(layout_arrays(layout, b, n),
                                              device)
        chain = Chain(forward_step(model, boxes, valid), scores)
        per_iter = marginal_seconds(chain, rng,
                                    *(LOOPS if on_card else (2, 6)))
        results[name] = {"ms_per_fwd": round(per_iter * 1e3, 3),
                         "dets_per_sec": round(b * n / per_iter, 0),
                         "B": b, "N": n, "layout": layout, "card": card}
        print(name, results[name], flush=True)
        del chain, model
    print(json.dumps(results), flush=True)
    print("DONE", flush=True)
    return results


if __name__ == "__main__":
    main()
