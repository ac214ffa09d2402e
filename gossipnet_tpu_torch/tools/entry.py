"""The flagship forward as one callable: the port's counterpart of
``__graft_entry__.py::entry``, with the flagship config and the synthetic
batch that ``tools/bench.py`` and ``tools/bench_suite.py`` measure.

    python -m gossipnet_tpu_torch.tools.entry [--device cpu]

builds the 16-block model (128/32/32, the config's other defaults, so
``pair_kernel: 2``: K1 in bf16), runs one forward of a B=4 batch (N=1024
on the card, N=256 on the CPU, as the reference chooses N by backend) and
prints ``entry ok: (4, N)``.

    python -m gossipnet_tpu_torch.tools.entry --dryrun-multichip 4

then runs :func:`dryrun_multichip`, every leg of the reference's
``__graft_entry__.py::dryrun_multichip`` on a world of that many ranks:
gloo on the CPU with ``--device cpu``; on the card NCCL with a card per
rank when there are enough, else gloo with every rank on ``cuda:0``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gossipnet_tpu_torch.config import Config, ModelConfig
from gossipnet_tpu_torch.data.bucketing import Batch, BatchIterator, make_batch
from gossipnet_tpu_torch.data.synthetic import (
    synthetic_record,
    synthetic_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.params import as_state_dict, init_params


def flagship_cfg() -> Config:
    """The paper-best flagship: 16 blocks, 128-d state, 32-d pair stage
    (``__graft_entry__.py:21 _flagship_cfg``)."""
    return Config(model=ModelConfig(num_blocks=16, feature_dim=128,
                                    reduced_dim=32, pairwise_dim=32))


def synthetic_arrays(batch: int, n: int, seed: int = 0, gt: int = 16) -> Batch:
    """``batch`` synthetic images of 6 detections per GT over ``n // 8``
    GTs and ``n // 8`` clutter boxes, padded to ``n`` detections and ``gt``
    GT slots (``__graft_entry__.py:29 _synthetic_arrays``)."""
    rng = np.random.default_rng(seed)
    records = [
        synthetic_record(rng, image_id=i, num_gt=max(n // 8, 1),
                         dets_per_gt=6, num_clutter=max(n // 8, 1))
        for i in range(batch)
    ]
    return make_batch(records, padded_n=n, padded_g=gt)


def coincident_arrays(batch: int, n: int, seed: int = 0) -> tuple:
    """(boxes, scores, valid) of ``batch`` images of ``n`` boxes within one
    pixel of the same 100 x 100 box: every pair's IoU is at least
    98² / 102² > 0.92, so every pair is a neighbour (the ``blob`` layout
    makes about 58% of them). The pair kernels' worst case: every ballot
    pushes 32 pairs."""
    rng = np.random.default_rng(seed)
    boxes = (np.array([300.0, 300.0, 400.0, 400.0])
             + rng.uniform(-1.0, 1.0, (batch, n, 4))).astype(np.float32)
    return (boxes, rng.uniform(0.3, 1.0, (batch, n)).astype(np.float32),
            np.ones((batch, n), bool))


def seeded_model(cfg: Config, device):
    """The model of ``cfg`` on ``device`` with ``init_params(seed=0)``
    weights, for inference: the pair kernel on the card, the dense plain
    path on the CPU (the reference's non-TPU choice)."""
    from gossipnet_tpu_torch.train import build_model

    pool_impl = "kernel" if device.type == "cuda" else "dense"
    model = build_model(cfg, pool_impl, device).eval()
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    return model


def device_tensors(batch: Batch, device) -> tuple:
    """(boxes, scores, valid) of ``batch`` on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (batch.boxes, batch.scores, batch.valid))


def entry(device="cuda"):
    """(fn, args): the flagship forward ``fn(params, boxes, scores, valid)
    -> logits`` and its arguments, the seeded weights (a ``state_dict`` on
    ``device``) and a B=4 batch, N=1024 on the card and 256 on the CPU.
    ``fn`` runs the model with the ``params`` it is given, as the
    reference's ``model.apply`` does."""
    device = resolve_device(device)
    model = seeded_model(flagship_cfg(), device)
    n = 1024 if device.type == "cuda" else 256
    boxes, scores, valid = device_tensors(synthetic_arrays(batch=4, n=n),
                                          device)

    def fn(params, boxes, scores, valid):
        with torch.inference_mode():
            return torch.func.functional_call(model, params,
                                              (boxes, scores, valid))

    return fn, (dict(model.state_dict()), boxes, scores, valid)


def _leg_config(n_data: int, n_det: int, tmp: str, tag: str,
                **model) -> dict:
    """The reference dryrun's small training config on an (n_data x
    n_det) mesh, as overrides (``__graft_entry__.py:116-125``)."""
    return {"model": {"num_blocks": 2, "feature_dim": 64, "reduced_dim": 32,
                      "pairwise_dim": 32, **model},
            "train": {"batch_size": max(n_data, 2), "learning_rate": 1e-3,
                      "max_steps": 2, "log_every": 1, "snapshot_every": 0,
                      "eval_every": 0, "checkpoint_dir": f"{tmp}/{tag}"},
            "data": {"bucket_sizes": [256]},
            "parallel": {"enable": "on", "data_axis": n_data,
                         "det_axis": n_det}}


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Every leg of ``__graft_entry__.py::dryrun_multichip`` on a world of
    ``n_devices`` ranks (``parallel.world.run_world``), checked here:

    1. ``train()`` on an (n/2 x 2) mesh from its config, two steps, finite
       losses; 1b. the same with 4 classes, class-aware matching at three
       thresholds; 1c. the raw sharded gradients against the local ones
       (f32, rtol 5e-4, atol 5e-6);
    2. ``Rescorer`` on each mesh shape the reference builds against the
       single-device Rescorer (rtol 1e-4, atol 1e-5);
    3. the evaluation through ``sharded_forward_fn``: a finite AP.
    """
    import tempfile

    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.parallel import legs
    from gossipnet_tpu_torch.parallel.world import run_world
    from gossipnet_tpu_torch.params import flatten_paths
    from gossipnet_tpu_torch.train import (
        build_model,
        host_arrays,
        loss_and_metrics,
    )

    device = resolve_device(device)
    n_det = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_det
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend, rank_device = "nccl", "cuda"    # a card per rank
    elif device.type == "cuda":                  # ranks share one card
        backend, rank_device = "gloo", torch.device("cuda", device.index or 0)
    else:
        backend, rank_device = "gloo", device

    tmp = tempfile.TemporaryDirectory(prefix="gnet_dryrun_")
    train_cfg = _leg_config(n_data, n_det, tmp.name, "ck")
    mc_cfg = _leg_config(n_data, n_det, tmp.name, "ck_mc", num_classes=4,
                         class_embed_dim=8)
    mc_cfg["matching"] = {"thresholds": [0.5, 0.6, 0.7],
                          "class_aware": True}
    bsz = max(n_data, 2)
    g_ov = {"model": {"num_blocks": 2, "feature_dim": 32, "reduced_dim": 16,
                      "pairwise_dim": 16, "pair_matmul_dtype": "float32"},
            "train": {"batch_size": bsz, "seed": 0},
            "data": {"bucket_sizes": [64]}, "parallel": {"enable": "off"}}
    g_cfg = load_config(None, g_ov)
    g_params = flatten_paths(init_params(g_cfg.model, seed=0))
    g_arrays = host_arrays(next(BatchIterator(
        synthetic_roidb(num_images=2 * bsz, seed=3), bsz,
        g_cfg.data.bucket_sizes, seed=0)))

    i_ov = {"model": {"num_blocks": 1, "feature_dim": 16, "reduced_dim": 8,
                      "pairwise_dim": 8, "pair_matmul_dtype": "float32"},
            "data": {"bucket_sizes": [64]}, "parallel": {"enable": "off"}}
    i_params = flatten_paths(init_params(load_config(None, i_ov).model,
                                         seed=0))
    rng = np.random.default_rng(0)
    images = []
    for _ in range(max(2 * n_devices, 8)):
        n = int(rng.integers(8, 40))
        xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        images.append((np.concatenate([xy, xy + 10], 1),
                       rng.uniform(0, 1, n).astype(np.float32), None))
    shapes = {(n_data, n_det)}
    if n_devices >= 2:
        shapes.add((n_devices, 1))
    if n_devices % 4 == 0:
        shapes.add((n_devices // 4, 4))
    shapes = sorted(shapes)

    def on_mesh(ov, d, t):
        return {**ov, "parallel": {"enable": "on", "data_axis": d,
                                   "det_axis": t}}

    plan = [
        ("train", legs.train_run, dict(
            overrides=train_cfg, metrics=True,
            data=dict(num_images=2 * bsz, seed=0, num_gt=32,
                      num_clutter=32))),
        ("train_mc", legs.train_run, dict(
            overrides=mc_cfg, metrics=True,
            data=dict(num_images=2 * bsz, seed=2, num_classes=4, num_gt=32,
                      num_clutter=32))),
        ("grads", legs.grads, dict(overrides=g_ov, params=g_params,
                                   arrays=g_arrays, shape=(n_data, n_det))),
        *((f"rescore_{d}x{t}", legs.rescore, dict(
            overrides=on_mesh(i_ov, d, t), params=i_params, images=images))
          for d, t in shapes),
        ("eval", legs.evaluate, dict(
            overrides=i_ov, params=i_params, shape=(n_data, n_det),
            data=dict(num_images=2 * bsz, seed=1), batch_size=bsz)),
    ]
    with tmp:
        got = run_world(legs.run_legs, n_devices, backend, rank_device,
                        args=(plan,))[0]

    for leg, what in (("train", ""), ("train_mc", "multiclass(4) + "
                                      "multi-threshold(3) ")):
        _, step, losses = got[leg]["result"]
        losses = [v for v in losses if v is not None]
        if step != 2 or not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{leg}: step {step}, losses {losses}")
        print(f"dryrun_multichip ok: {what}train mesh=({n_data}x{n_det}) "
              f"via train() CLI path, loss={losses[-1]:.4f}", flush=True)

    model = build_model(g_cfg, "kernel", device)
    model.load_state_dict(as_state_dict(g_params))
    loss, _ = loss_and_metrics(model, {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in g_arrays.items()}, g_cfg)
    loss.backward()
    sharded, _ = got["grads"]["result"]
    for name, p in model.named_parameters():
        np.testing.assert_allclose(sharded[name], p.grad.cpu().numpy(),
                                   rtol=5e-4, atol=5e-6, err_msg=name)
    print(f"dryrun_multichip ok: sharded raw grads on ({n_data}x{n_det}) "
          f"match local grads ({len(sharded)} tensors)", flush=True)

    local = Rescorer(load_config(None, i_ov), i_params, device=device,
                     mesh=None)
    want = local.rescore_batch(images)
    for d, t in shapes:
        (scores,) = got[f"rescore_{d}x{t}"]["result"]
        for w, g in zip(want, scores):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        print(f"dryrun_multichip ok: sharded inference mesh=({d}x{t}) "
              f"matches single-device on {len(images)} images", flush=True)

    stats = got["eval"]["result"]["stats"]
    if not np.isfinite(stats["AP"]):
        raise AssertionError(f"mesh eval: {stats}")
    print(f"dryrun_multichip ok: mesh eval path AP={stats['AP']:.4f}",
          flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dryrun-multichip", type=int, default=None,
                   metavar="N",
                   help="then run every leg of the multi-chip dry run on a "
                        "world of N ranks")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), flush=True)
    if args.dryrun_multichip:
        dryrun_multichip(args.dryrun_multichip, args.device)


if __name__ == "__main__":
    main()
