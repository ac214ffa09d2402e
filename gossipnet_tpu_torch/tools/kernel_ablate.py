"""Per-tile ablation of the pair tile on the card (port of
``scripts/kernel_ablate.py``): what each stage of K5's tile costs.

    python -m gossipnet_tpu_torch.tools.kernel_ablate [MODE|all] [TILE_J]

MODE is one of ``full nofeat nogw nofc2 nomask bf3d`` (default ``full``),
TILE_J the staged column tile, 32, 64 or 128 (default 64; the row tile is
32, one lane per row). The inputs are the probe's: B=8 images of N=1024
boxes of 20-80 pixels in a 600-pixel canvas, P=32, G=8, all valid, drawn
with ``np.random.default_rng(0)`` in the probe's order. After a warm-up
launch, 40 launches are chained (each output feeds ``a`` of the next) and
timed with CUDA events; one line per mode gives ms/call and us/tile over
the card's own tile count B * (N/32) * (N/TILE_J), with the card's name
and power limit in front. ``all`` runs the six modes and prints
``full - mode``, the time the switched-off stage costs: K7 is dense (every
pair through every stage the mode keeps, the mask a select at the end), so
the share of pairs that pass the mask, which ``nofeat``'s stand-in IoU and
``nomask`` change, does not move a mode's work.

It runs K7 (``ops/cuda/ablate.py``) on the CUDA device and raises when
there is none. ``--device cpu`` runs the plain version instead and times
it with the host clock (a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import ablate

CALLS = 40   # launches in the timed chain


def probe_inputs(batch: int = 8, n: int = 1024, canvas: float = 600.0,
                 seed: int = 0, device="cpu") -> dict:
    """The probe's inputs in K7's layouts, as tensors on ``device``: cols
    [B, 14, N], a, b [B, N, P], wg [G, P], w2 [P, P] (in, out), b2 [P].
    The draws are the probe's, in its order ([B, P, N] and [P, G] arrays,
    transposed here), so the same seed gives the same values."""
    p, g = ablate.P, ablate.G
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, canvas, (batch, n, 2))
    wh = rng.uniform(20, 80, (batch, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    a_t = rng.normal(0, 1, (batch, p, n)).astype(np.float32)
    b_t = rng.normal(0, 1, (batch, p, n)).astype(np.float32)
    wg_t = rng.normal(0, .3, (p, g)).astype(np.float32)
    w2_t = rng.normal(0, .3, (p, p)).astype(np.float32)
    b2c = rng.normal(0, .3, (p, 1)).astype(np.float32)
    cols = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.ones((batch, n), dtype=torch.bool)))

    def dev(x):
        return torch.as_tensor(x).contiguous().to(device)

    return {"cols": dev(cols), "a": dev(a_t.transpose(0, 2, 1)),
            "b": dev(b_t.transpose(0, 2, 1)), "wg": dev(wg_t.T),
            "w2": dev(w2_t.T), "b2": dev(b2c[:, 0])}


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (plain version, host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or torch.cuda.get_device_name(device)


def time_chain(inputs: dict, mode: str, tile_j: int, calls: int = CALLS):
    """Warm up once, then chain ``calls`` launches (the output feeds a) ->
    (ms per call, sum of the last output, K7 launches the chain made by
    the wrapper's counter: ``calls`` on the card, 0 on the CPU)."""
    rest = (inputs["b"], inputs["wg"], inputs["w2"], inputs["b2"], mode,
            tile_j)
    x = inputs["a"]
    cuda = x.device.type == "cuda"
    float(ablate.pair_ablate(inputs["cols"], x, *rest).sum())
    before = ablate.pair_ablate.launches
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        x = ablate.pair_ablate(inputs["cols"], x, *rest)
    if cuda:
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop) / calls
    else:
        ms = (time.perf_counter() - t0) * 1e3 / calls
    return ms, float(x.sum()), ablate.pair_ablate.launches - before


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        description="Per-tile ablation of the pair tile (K7)")
    p.add_argument("mode", nargs="?", default="full",
                   choices=ablate.MODES + ("all",))
    p.add_argument("tile_j", nargs="?", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("-n", type=int, default=1024, help="detections per image")
    p.add_argument("--calls", type=int, default=CALLS)
    args = p.parse_args(argv)
    if args.tile_j not in ablate.TILE_JS:
        p.error(f"TILE_J must be one of {ablate.TILE_JS}")
    device = resolve_device(args.device)
    inputs = probe_inputs(args.batch, args.n, device=device)
    label = card_label(device)
    ntiles = ablate.tile_count(args.batch, args.n, args.tile_j)
    modes = ablate.MODES if args.mode == "all" else (args.mode,)
    results = []
    for mode in modes:
        ms, s, launches = time_chain(inputs, mode, args.tile_j, args.calls)
        results.append({"mode": mode, "tile_j": args.tile_j, "ms": ms,
                        "us_per_tile": ms * 1e3 / ntiles, "sum": s,
                        "launches": launches})
        print(f"{label}: MODE={mode} TI={ablate.TILE_I} TJ={args.tile_j} "
              f"BF=True: {ms:.4f} ms/call, {ms * 1e3 / ntiles:.4f} us/tile "
              f"(sum={s:.1f})", flush=True)
    if args.mode == "all":
        full = results[0]["ms"]
        for r in results[1:]:
            r["full_minus_ms"] = full - r["ms"]
            print(f"{label}: full - {r['mode']} = {full - r['ms']:+.4f} "
                  f"ms/call", flush=True)
    return results


if __name__ == "__main__":
    main()
