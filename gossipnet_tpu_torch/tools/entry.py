"""The flagship forward as one callable: the port's counterpart of
``__graft_entry__.py::entry``, with the flagship config and the synthetic
batch that ``tools/bench.py`` and ``tools/bench_suite.py`` measure.

    python -m gossipnet_tpu_torch.tools.entry [--device cpu]

builds the 16-block model (128/32/32, the config's other defaults, so
``pair_kernel: 2``: K1 in bf16), runs one forward of a B=4 batch (N=1024
on the card, N=256 on the CPU, as the reference chooses N by backend) and
prints ``entry ok: (4, N)``. The reference's ``dryrun_multichip`` runs every
leg on a device mesh and comes with ``parallel/`` (ROADMAP item 14).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gossipnet_tpu_torch.config import Config, ModelConfig
from gossipnet_tpu_torch.data.bucketing import Batch, make_batch
from gossipnet_tpu_torch.data.synthetic import synthetic_record
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), flush=True)


if __name__ == "__main__":
    main()
