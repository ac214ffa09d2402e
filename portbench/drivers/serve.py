"""What the two serving drivers share: the server, the pools, the senders
and the check.

The program under test is ``gossipnet_tpu_torch.serving.TcpServer`` over
``api.Rescorer``, built as the serve CLI builds it (batch 8, threshold
0.5, no shedding), started (which captures every padded shape) and fed
binary frames over TCP by sender processes (``traffic/sender.py``). The
weights are the benchmark's, drawn from the seed on the device.

The check: once the window has closed and the program is freed, a sample
of the answered requests, drawn from the seed with the largest image in
it, is rescored by the reference (``reference/gossipnet.py``) and each
reply's scores are held to the reference's probabilities: the widest gap
over every detection of the sample. A request never answered, answered
with an error or with the wrong count counts apart, exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench import common, counts, weights
from portbench.reference import gossipnet as ref_model
from portbench.trace import TRACE_S, Profile

SENDER = Path(__file__).resolve().parents[1] / "traffic" / "sender.py"
GRACE_S = 60.0


def key(preset: str, index: int) -> str:
    return f"{preset}:{index}"


class Server:
    """The program's server on a free port, with the benchmark's weights."""

    def __init__(self, bench):
        import torch

        from gossipnet_tpu_torch.api import Rescorer
        from gossipnet_tpu_torch.serving import TcpServer

        self.device = torch.device(bench.device)
        self.cfg = common.program_config(bench)
        params = weights.make(common.model_dict(bench), bench.seed,
                              self.device)
        self.rescorer = Rescorer(self.cfg, params, pool_impl="kernel",
                                 device=self.device)
        self.server = TcpServer(self.rescorer, port=0,
                                batch_size=self.cfg.train.batch_size).start()
        self.params = params

    def stats(self) -> dict:
        with self.server._stats_lock:
            return dict(self.server.stats)

    def capture_seconds(self) -> float:
        from gossipnet_tpu_torch.utils.cuda_graphs import forward_graphs

        return float(sum(forward_graphs(self.rescorer.model)
                         .capture_seconds().values()))

    def stop(self) -> None:
        self.server.stop()
        self.rescorer = self.server = None


def write_pools(path: str, pools: dict) -> None:
    arrays = {}
    for preset, ims in pools.items():
        for i, im in enumerate(ims):
            arrays[key(preset, i) + "|boxes"] = im.boxes
            arrays[key(preset, i) + "|scores"] = im.scores
    np.savez(path, **arrays)


def start_senders(specs: list[dict], tmp: str) -> list:
    procs = []
    for i, spec in enumerate(specs):
        path = os.path.join(tmp, f"sender{i}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs.append(subprocess.Popen(
            [sys.executable, str(SENDER), path], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True))
    for p in procs:
        line = p.stdout.readline().strip()
        if line != "ready":
            raise RuntimeError(f"a sender did not start: {line!r}")
    return procs


def release_senders(procs: list, t0: float) -> None:
    for p in procs:
        p.stdin.write(f"{t0!r}\n")
        p.stdin.flush()


def wait_senders(procs: list, timeout: float) -> None:
    end = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(end - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            raise RuntimeError(f"a sender failed ({p.returncode})")


def window(bench, server: Server, procs: list) -> tuple[float, dict, dict]:
    """Releases the senders: the mix's ``warm_s`` seconds of its traffic,
    then the window -> (t0, the server's counters at the window's start
    and at its end). Set-up ends at t0, when the first timed request is
    due; the trace covers the window's first ``TRACE_S`` seconds."""
    warm = float(bench.traffic.get("warm_s", 0.0))
    profile = Profile(bench.trace).start()
    t0 = time.monotonic() + warm + 0.25
    release_senders(procs, t0)
    time.sleep(max(t0 - time.monotonic(), 0.0))
    bench.ready()
    before = server.stats()
    profile.open()
    time.sleep(max(t0 + min(TRACE_S, bench.seconds) - time.monotonic(), 0.0))
    profile.close()
    profile.stop()
    time.sleep(max(t0 + bench.seconds - time.monotonic(), 0.0))
    after = server.stats()
    bench.profile = profile if bench.trace else None
    bench.window_s = bench.seconds
    return t0, before, after


def finish(bench, server: Server, before: dict, after: dict) -> None:
    """What the program says about the window, then the program freed."""
    bench.memory_peak_bytes = common.memory_peak(server.device)
    bench.layer["server"] = {k: after[k] - before[k]
                             for k in ("images", "batches")}
    bench.layer["capture_s"] = server.capture_seconds()
    bench.layer["model"] = common.model_dict(bench)
    bench.layer["launches"] = (bench.layer["server"]["batches"]
                               * bench.layer["model"]["num_blocks"])
    server.stop()


def served_work(bench, images: dict, served: list) -> None:
    """Neighbour pairs and detections of the images served in the traced
    part of the window (traced runs only)."""
    if not bench.trace:
        return
    pairs_of = {}
    for k in set(served):
        pairs_of[k] = counts.neighbour_pairs(images[k].boxes)
    bench.layer["pairs"] = sum(pairs_of[k] for k in served)
    bench.layer["dets"] = sum(len(images[k].scores) for k in served)


def gaps(bench, params, device, sample: list) -> list:
    """sample: (image, program scores) -> each reply's absolute gaps to
    the reference's probabilities."""
    import torch

    ref_model.no_tf32()
    out = []
    blocks = common.model_dict(bench)["num_blocks"]
    with torch.no_grad():
        for im, got in sample:
            if len(im.scores) == 0:
                continue
            geom = ref_model.Geometry(torch.as_tensor(im.boxes, device=device),
                                      torch.as_tensor(im.scores,
                                                      device=device))
            want = torch.sigmoid(ref_model.forward(params, geom, blocks))
            got = torch.as_tensor(got, device=device)
            out.append((got - want).abs().cpu().numpy())
    return out


def check(bench, params, device, sample: list) -> None:
    """Holds the sample's replies to the reference: the widest gap."""
    per_reply = gaps(bench, params, device, sample)
    widest = max((float(g.max()) for g in per_reply), default=0.0)
    bench.check("score_gap", widest, bench.workload["limits"]["score_gap"])


def flat_images(pools: dict) -> dict:
    return {key(p, i): im for p, ims in pools.items()
            for i, im in enumerate(ims)}
