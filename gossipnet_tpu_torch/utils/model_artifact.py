"""Serving artifacts: one file that serves without the training config or
a checkpoint directory (port of ``gossipnet_tpu/utils/model_artifact.py``).

    # export (once, after training)
    export_artifact(cfg, params, "gnet.gnetart", batch_sizes=(1, 2, 4, 8))

    # serve
    rescorer = ArtifactRescorer("gnet.gnetart")   # device="cuda"
    new_scores = rescorer(boxes, scores)           # the full Rescorer API:
    rescorer.rescore_batch(...) / rescore_stream / TcpServer(rescorer)

    python -m gossipnet_tpu_torch.utils.model_artifact -c cfg.yaml \\
        --checkpoint-dir checkpoints --out gnet.gnetart --batches 1,2,4,8

Format decision: the artifact holds weights, not a compiled program. The
reference serialises one ``jax.export`` program per (batch, bucket) shape;
``torch.export`` cannot trace the pair kernels' ctypes launches
(``ops/cuda/launch.py``), so the port's artifact is a zip of

- ``meta.json``: ``format_version``, ``"runtime": "torch"``, the
  ``[b, n]`` shape inventory, the full Config tree and ``pool_impl``;
- ``params.npz``: the weights in the reference's NPZ convention
  (``utils/export.py``).

``ArtifactRescorer`` builds the model from that config and serves exactly
the exported shapes, as the reference's does: the buckets come from the
inventory, a group pads to the smallest exported batch that fits, and any
other shape raises ``KeyError`` naming the inventory. The artifact is
device-free: the same file serves on the card and on the CPU. A JAX
artifact (``blobs/*.jaxexp``) is refused by name.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from pathlib import Path

import numpy as np

from gossipnet_tpu_torch.api import Rescorer, zero_batch
from gossipnet_tpu_torch.config import Config, load_config
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.utils.export import (
    load_params_npz,
    save_params_npz,
)

FORMAT_VERSION = 1
_META = "meta.json"
_PARAMS = "params.npz"


def export_artifact(cfg: Config, params, path, batch_sizes=(1, 2, 4, 8),
                    pool_impl: str = "kernel") -> dict:
    """Write the artifact for every (batch in ``batch_sizes``, bucket)
    shape; ``params`` is a ``state_dict`` or a JAX tree. Returns the meta
    dict."""
    if not cfg.data.bucket_sizes or not batch_sizes:
        raise ValueError(
            f"nothing to export: bucket_sizes="
            f"{tuple(cfg.data.bucket_sizes)}, "
            f"batch_sizes={tuple(batch_sizes)}")
    if pool_impl not in ("kernel", "dense"):
        raise ValueError(f"pool_impl must be 'kernel' or 'dense', got "
                         f"{pool_impl!r}")
    shapes = [[b, n] for n in cfg.data.bucket_sizes
              for b in sorted({int(x) for x in batch_sizes})]
    meta = {
        "format_version": FORMAT_VERSION,
        "runtime": "torch",
        "pool_impl": pool_impl,
        "shapes": shapes,
        "config": dataclasses.asdict(cfg),
    }
    buf = io.BytesIO()
    save_params_npz(buf, params)
    with zipfile.ZipFile(Path(path), "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META, json.dumps(meta, indent=1))
        z.writestr(_PARAMS, buf.getvalue())
    return meta


def read_artifact_meta(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read(_META))


class ArtifactRescorer(Rescorer):
    """The full Rescorer API (one-image call, ``rescore_batch`` /
    ``rescore_stream`` / ``rescore_async``, ``TcpServer``) served from an
    artifact instead of model code, config file and checkpoint.

    Shapes are bounded by the export: a group that pads to a (batch,
    bucket) pair that was not exported raises a KeyError naming the
    available set.
    """

    def __init__(self, path, device="cuda"):
        self._path = str(path)
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read(_META))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"artifact {path} has format_version "
                    f"{meta['format_version']}; this build reads "
                    f"<= {FORMAT_VERSION}")
            if _PARAMS not in z.namelist():
                raise ValueError(
                    f"artifact {path} holds no {_PARAMS} (runtime "
                    f"{meta.get('runtime', 'jax')!r}, platforms "
                    f"{meta.get('platforms')}): it is a JAX/TPU artifact of "
                    "gossipnet_tpu; export one with python -m "
                    "gossipnet_tpu_torch.utils.model_artifact")
            params = load_params_npz(io.BytesIO(z.read(_PARAMS)))
        self.meta = meta
        self._shapes = {(int(b), int(n)) for b, n in meta["shapes"]}
        self._max_batch = max(b for b, _ in self._shapes)
        cfg_dict = dict(meta["config"])
        # The buckets are the exported set, not whatever the training
        # config had beyond it.
        cfg_dict["data"] = {**cfg_dict["data"], "bucket_sizes":
                            sorted({n for _, n in self._shapes})}
        cfg = load_config(None, overrides=cfg_dict)
        super().__init__(cfg, params, pool_impl=meta["pool_impl"],
                         device=resolve_device(device))

    def _pad_batch(self, b: int) -> int:
        """Smallest exported batch size that fits the group."""
        fits = sorted(eb for eb, _ in self._shapes if eb >= b)
        if not fits:
            raise KeyError(
                f"artifact {self._path} exports batches up to "
                f"{self._max_batch}; got a {b}-image group: lower "
                f"batch_size or re-export with larger batch_sizes")
        return fits[0]

    def _check_shape(self, b: int, n: int) -> None:
        if (b, n) not in self._shapes:
            raise KeyError(
                f"artifact {self._path} has no exported shape "
                f"(batch={b}, n={n}); available: {sorted(self._shapes)}")

    def _dispatch(self, boxes_a, scores_a, valid_a, classes_a):
        b, n = scores_a.shape
        self._check_shape(self._pad_batch(b), n)
        return super()._dispatch(boxes_a, scores_a, valid_a, classes_a)

    def exported_shapes(self) -> list[tuple[int, int]]:
        """Sorted (batch, bucket) pairs this artifact can dispatch."""
        return sorted(self._shapes)

    def forward(self, boxes, scores, valid, classes=None) -> np.ndarray:
        """Probabilities at exactly ``scores.shape`` = (b, n), which must
        be an exported shape (KeyError naming the inventory otherwise).
        ``classes`` defaults to zeros. The building block for batch
        runners that do their own padding (``evaluate --artifact``)."""
        self._check_shape(*scores.shape)
        if classes is None:
            classes = np.zeros(scores.shape, np.int32)
        return self._run(boxes, scores, valid, classes)

    def max_batch_for(self, n: int) -> int:
        """Largest exported batch for bucket ``n`` (0 if none): the
        TcpServer's per-bucket batch caps clamp to it."""
        return max((b for b, nn in self._shapes if nn == n), default=0)

    def reload(self, params=None, *, checkpoint_dir=None,
               best: bool = True) -> None:
        """The weights are the artifact's: export a new artifact and
        restart, or serve from a checkpoint directory for hot reload."""
        del params, checkpoint_dir, best
        raise ValueError(
            f"artifact {self._path}: weights are baked into the artifact; "
            "hot reload needs checkpoint-backed serving (drop --artifact)")

    def warmup(self, batch_size: int | None = None) -> None:
        """Run every exported shape once."""
        del batch_size  # the exported set is the reachable set
        for b, n in sorted(self._shapes):
            self._run(*zero_batch(b, n))


def main(argv=None):
    """Export CLI: trained checkpoint (or params NPZ) -> serving artifact,
    then served once at every exported shape on ``--device``."""
    import argparse

    p = argparse.ArgumentParser(
        description="Export a serving artifact (python -m "
                    "gossipnet_tpu_torch.utils.model_artifact). The "
                    "artifact holds the config and the weights, not a "
                    "compiled program, so it is device-free and there is "
                    "no --platforms option: the same file serves on the "
                    "card and on the CPU.")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--out", required=True, help="artifact path (.gnetart)")
    p.add_argument("--batches", default="1,2,4,8",
                   help="comma list of batch sizes to export")
    p.add_argument("--params-npz", default=None,
                   help="weights NPZ (utils/export.py, either package's) "
                        "instead of a checkpoint dir")
    p.add_argument("--pool-impl", default="kernel",
                   choices=("kernel", "dense"),
                   help="pair stage the artifact serves with (default: "
                        "the CUDA pair kernel of model.pair_kernel; on the "
                        "CPU its plain version)")
    p.add_argument("--device", default="cuda",
                   help="where the exported shapes are served once after "
                        "writing: cuda (default; raises without a card) "
                        "or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.params_npz:
        params = load_params_npz(args.params_npz)
    else:
        params = Rescorer.load_checkpoint_params(cfg, args.checkpoint_dir)
    batches = tuple(int(x) for x in args.batches.split(","))
    meta = export_artifact(cfg, params, args.out, batch_sizes=batches,
                           pool_impl=args.pool_impl)
    ArtifactRescorer(args.out, device=device).warmup()
    size = Path(args.out).stat().st_size
    print(f"wrote {args.out}: {len(meta['shapes'])} shapes, "
          f"{size / 1e6:.1f} MB; each served once on {device}")


if __name__ == "__main__":
    main()
