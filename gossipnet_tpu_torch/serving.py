"""Serving runtime: the JSON-lines stdin/stdout stream and its CLI (port of
``gossipnet_tpu/serving.py``'s ``serve_stream``, ``_build`` and ``main``).

    python -m gossipnet_tpu_torch.serve -c experiments/serving_bucketed.yaml \\
        --random-init

One image per line on stdin, responses on stdout, double-buffered through
``Rescorer.rescore_stream``::

    {"id": 7, "boxes": [[0,0,10,10],[1,1,11,11]], "scores": [0.9, 0.8]}
    -> {"id": 7, "new_scores": [0.93, 0.04], "keep": [0]}

It runs on the CUDA device and raises when there is none. Not ported yet:
``--tcp`` (TcpServer) and ``--input`` (serve_file), ROADMAP.md item 12;
``--checkpoint-dir`` and ``--artifact``, ROADMAP.md item 13. Until then
the CLI serves seeded random weights (``--random-init``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.params import init_params

__all__ = ["serve_stream", "main"]


def _build(args) -> Rescorer:
    cfg = load_config(args.config) if args.config else load_config(None)
    if not args.random_init:
        raise SystemExit(
            "loading trained weights (--checkpoint-dir, --artifact) is not "
            "ported yet (ROADMAP.md item 13); pass --random-init")
    return Rescorer(cfg, init_params(cfg.model, seed=0))


def serve_stream(rescorer: Rescorer, threshold: float,
                 inp=sys.stdin, out=sys.stdout, sync: bool = False) -> int:
    """JSON-lines loop; returns number of images served.

    Default: double-buffered batching (responses may trail requests by one
    batch). ``sync``: answer each request immediately.

    A malformed request (bad JSON, missing/mismatched fields, more
    detections than the largest bucket) gets an ``{"id", "error"}`` reply
    and the loop keeps serving.
    """
    def error(rid, msg):
        out.write(json.dumps({"id": rid, "error": str(msg)[:200]}) + "\n")
        out.flush()

    def requests():
        for line in inp:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                error(None, f"bad json: {e}")
                continue
            if not isinstance(req, dict):
                error(None, "request must be a JSON object")
                continue
            yield req

    def arrays(req):
        """Parse + validate one request; ValueError -> error reply."""
        boxes = np.asarray(req["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(req["scores"], np.float32)
        classes = (np.asarray(req["classes"], np.int32)
                   if "classes" in req else None)
        if len(boxes) != len(scores):
            raise ValueError(f"boxes/scores length mismatch: "
                             f"{len(boxes)} vs {len(scores)}")
        rescorer._check_image(req.get("id"), scores, classes,
                              truncate=False)
        return boxes, scores, classes

    def respond(req, idx, new_scores):
        keep = np.nonzero(new_scores > threshold)[0]
        out.write(json.dumps({
            "id": req.get("id", idx),
            "new_scores": [round(float(s), 6) for s in new_scores],
            "keep": keep.tolist(),
        }) + "\n")
        out.flush()

    if sync:
        n = 0
        for idx, req in enumerate(requests()):
            try:
                new_scores = rescorer(*arrays(req))
            except (KeyError, ValueError, TypeError) as e:
                error(req.get("id", idx), e)
                continue
            respond(req, idx, new_scores)
            n += 1
        return n

    # Keyed by stream index and popped on response, so a long-running
    # server holds at most the in-flight window of requests.
    reqs: dict = {}

    def images():
        k = 0
        for req in requests():
            try:
                arr = arrays(req)
            except (KeyError, ValueError, TypeError) as e:
                error(req.get("id"), e)
                continue
            # Only accepted requests get a stream index: rescore_stream
            # enumerates ITS input.
            reqs[k] = req
            k += 1
            yield arr

    n = 0
    for idx, new_scores in rescorer.rescore_stream(images()):
        respond(reqs.pop(idx), idx, new_scores)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--random-init", action="store_true",
                   help="seeded random weights (smoke tests only)")
    p.add_argument("--sync", action="store_true",
                   help="answer each stdin request immediately "
                        "(interactive latency, no batching)")
    args = p.parse_args(argv)
    rescorer = _build(args)
    n = serve_stream(rescorer, args.threshold, sync=args.sync)
    print(f"served {n} images", file=sys.stderr)


if __name__ == "__main__":
    main()
