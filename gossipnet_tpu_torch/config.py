"""Configuration tree for gossipnet_tpu_torch.

A copy of ``gossipnet_tpu.config`` (the port imports nothing of the JAX
package): the same frozen dataclass tree, deep merge and validation, so
every shipped ``experiments/*.yaml`` loads unchanged. Every field is kept;
the ones this port cannot honour yet raise ``NotImplementedError`` where
the model is built (``models/gossipnet.py::check_supported``), naming the
ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """GossipNet architecture knobs (reference: nms_net/network.py, Gnet)."""

    num_blocks: int = 16          # K stacked gossip blocks (paper best: 16)
    feature_dim: int = 128        # per-detection state width c_i
    reduced_dim: int = 32         # reduced width r_i inside a block
    pairwise_dim: int = 32        # pair MLP width
    # FCs applied to the pooled m_i before the residual add: the first
    # expand_hidden_layers-1 are relu FCs of width pairwise_dim, the last
    # maps to feature_dim (paper default: 2 total). The PAIR MLP depth is
    # fixed at 2: the pair kernel is built around the split form
    # a_i + b_j + g@Wg -> FC2 (ops/cuda/pairwise2.py).
    expand_hidden_layers: int = 2
    neighbor_iou: float = 0.2     # pair set: IoU(b_i, b_j) >= 0.2, incl. self
    num_classes: int = 1          # 1 = class-agnostic (COCO persons); 81 etc.
    class_embed_dim: int = 32     # class embedding width (multi-class only)
    score_rank_feature: bool = True  # include per-class score-rank feature
    dtype: str = "float32"        # compute dtype for block matmuls
    # Operand dtype of the pair kernel's two products: bfloat16 rounds the
    # features, b', the weights and h1 as the TPU kernel does; sums stay
    # float32. 'float32' is IEEE f32 throughout.
    pair_matmul_dtype: str = "bfloat16"
    # Block-sparse pair kernel: skip tiles whose row and column bounding
    # boxes cannot overlap (exact for neighbor_iou > 0). With
    # sort_detections (a Morton sort, undone on the logits) most tiles of
    # a clustered image skip.
    block_sparse: bool = True
    sort_detections: bool = True
    # The TPU kernel's tile shape. Accepted and ignored: the CUDA kernels
    # have their own tile (ops/cuda/launch.py TILE_I x TILE_J), and the
    # result does not depend on the tile.
    pair_tile_i: int = 128
    pair_tile_j: int = 128
    # Pair-kernel generation: 2 = the separable-fold kernel K1/K2
    # (ops/cuda/pairwise2.py); 1 = the unfolded kernel K5/K6
    # (ops/cuda/pairwise.py).
    pair_kernel: int = 2
    # Elementwise dtype of the pair stage's streamed tensors; only
    # float32 is ported. Requires pair_matmul_dtype='bfloat16'.
    pair_elementwise_dtype: str = "float32"


@dataclass(frozen=True)
class MatchingConfig:
    """det<->GT matching for the training loss.

    Reference: matching_module/det_matching.cc — greedy assignment in
    descending predicted-score order, recomputed every step. The rebuild
    keeps the same algorithm as a vectorized lax.scan (ops/matching.py).
    """

    thresholds: Sequence[float] = (0.5,)  # single or COCO 0.5:0.95 sweep
    class_aware: bool = False             # multi-class: match within class
    crowd_as_ignore: bool = True          # crowd GT -> zero-weight, not neg


@dataclass(frozen=True)
class LossConfig:
    """Weighted logistic loss (paper §4)."""

    pos_weight_mode: str = "balanced"  # 'balanced' | 'fixed' | 'none'
    fixed_pos_weight: float = 1.0
    # 'per_image': weights normalize within each image, images contribute
    # equally (the batched default). 'per_batch': the whole batch pools
    # into one weighting problem — pos/neg balance computed across
    # images, so detection-heavy images contribute more; this matches
    # the reference's 1-image-per-step regime where no distinction
    # exists (reference: nms_net/network.py loss subgraph). NB
    # 'per_batch' is incompatible with a data-sharded mesh (each shard
    # would pool only its local images); make_sharded_train_step
    # refuses the combination.
    normalize: str = "per_image"


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    lr_schedule: str = "constant"      # 'constant' | 'step' | 'cosine'
    lr_decay_steps: Sequence[int] = ()
    lr_decay_rate: float = 0.1
    warmup_steps: int = 0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0        # 0 disables
    max_steps: int = 200_000
    batch_size: int = 8                # images per step (ref: 1 image/step)
    snapshot_every: int = 10_000
    eval_every: int = 20_000
    log_every: int = 100
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    remat_blocks: bool = False          # jax.checkpoint each gossip block
    # Optimizer steps executed per host->device call (lax.scan over
    # pre-stacked same-shape batches). >1 amortizes host dispatch latency;
    # logging/checkpoint cadence rounds to multiples of this.
    steps_per_call: int = 1
    # Gradient accumulation (optax.MultiSteps): average grads over k
    # micro-batches before one optimizer update — effective batch
    # k x batch_size at batch_size memory (the N=4096 crowd config is
    # memory-bound at B=2). max_steps/log_every/etc. keep counting
    # MICRO-batches; LR schedules advance per parameter UPDATE, so
    # schedule horizons (cosine decay, step boundaries, warmup) are
    # interpreted in micro-steps and scaled by 1/k internally.
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"       # 'synthetic' | 'coco' | 'pets'
    ann_file: str = ""               # COCO annotation json / PETS CVML xml
    det_file: str = ""               # precomputed detections
    #                                  (coco: npz/json; pets: xml/csv/npz)
    # Validation split (reference: minival) for periodic train-time eval
    # + best-AP checkpointing; empty = no periodic eval for coco/pets.
    val_ann_file: str = ""
    val_det_file: str = ""
    person_only: bool = True         # persons subset vs all 80 classes
    max_detections: int = 1024       # cap (score-ranked) per image, pad to N
    bucket_sizes: Sequence[int] = (256, 512, 1024, 2048, 4096)
    shuffle: bool = True


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh execution, consumed by train() and api.Rescorer.

    The reference is strictly single-device (SURVEY.md §2.3); this is
    the rebuild's scaling surface. 'auto' builds a ('data', 'det') mesh
    whenever more than one device is visible; a single YAML knob flips
    the same code path the CLI uses onto any mesh shape.
    """

    enable: str = "auto"        # 'auto' | 'on' | 'off'
    data_axis: int = 0          # mesh size along 'data' (0 = all remaining)
    det_axis: int = 1           # mesh size along 'det' (pair-row sharding)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def _merge_dataclass(dc: Any, overrides: Mapping[str, Any]) -> Any:
    """Deep-merge a mapping of overrides into a frozen dataclass tree.

    Mirrors the reference's ``cfg_from_file`` deep merge semantics
    (reference: nms_net/config.py) but type-checks against the schema:
    unknown keys raise instead of silently extending the config.
    """
    if not dataclasses.is_dataclass(dc):
        raise TypeError(f"not a dataclass: {dc!r}")
    valid = {f.name: f for f in dataclasses.fields(dc)}
    updates = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(
                f"unknown config key {key!r} for {type(dc).__name__}; "
                f"valid keys: {sorted(valid)}"
            )
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _merge_dataclass(current, value)
        else:
            if isinstance(current, tuple) and isinstance(value, list):
                value = tuple(value)
            updates[key] = value
    return dataclasses.replace(dc, **updates)


def experiment_path(name: str) -> str:
    """Resolve a shipped experiment YAML by name in either layout.

    Repo checkout: ``<repo>/experiments/<name>.yaml``. Installed wheel:
    ``gossipnet_tpu_torch/experiments/<name>.yaml``. Accepts the name with
    or without the ``.yaml`` suffix; raises FileNotFoundError listing what IS
    available otherwise.
    """
    from pathlib import Path

    fname = name if name.endswith(".yaml") else f"{name}.yaml"
    here = Path(__file__).resolve()
    candidates = [here.parents[1] / "experiments" / fname,
                  here.parent / "experiments" / fname]
    for c in candidates:
        if c.exists():
            return str(c)
    have: list[str] = []
    for d in {c.parent for c in candidates}:
        if d.is_dir():
            have += sorted(p.stem for p in d.glob("*.yaml"))
    raise FileNotFoundError(
        f"no experiment {name!r}; available: {have or 'none'}")


def load_config(path: str | None = None,
                overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a Config from defaults + optional YAML file + optional dict.

    YAML structure mirrors the dataclass tree::

        model:
          num_blocks: 16
        train:
          learning_rate: 1.0e-4
    """
    cfg = Config()
    if path:
        import yaml  # deferred: pyyaml is present in the image

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        cfg = _merge_dataclass(cfg, loaded)
    if overrides:
        cfg = _merge_dataclass(cfg, overrides)
    if cfg.data.max_detections > max(cfg.data.bucket_sizes):
        # Clamp rather than refuse: many configs shrink bucket_sizes and
        # leave max_detections at its default. Loaders cap each image to
        # max_detections BY SCORE; anything above the largest bucket
        # would instead be truncated by make_batch's input-order prefix
        # — silently dropping high-scoring detections and desyncing
        # rescore_roidb's output length from the record's num_dets.
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, max_detections=max(cfg.data.bucket_sizes)))
    validate_config(cfg)
    return cfg


def validate_config(cfg: Config) -> None:
    """Refuse configs whose values would train silently wrong.

    Matching thresholds must lie in (0, 1]: the batched Pallas matching
    path (the TPU default) folds padding/crowd/class exclusions into
    zeroed IoU rows and therefore REQUIRES t > 0 (ops/matching.py) —
    a YAML with ``thresholds: [0.0]`` would train with wrong labels on
    TPU while the CPU scan stayed correct. t > 1 can never match and is
    always a typo.
    """
    for t in cfg.matching.thresholds:
        if not 0.0 < float(t) <= 1.0:
            raise ValueError(
                f"matching.thresholds must be in (0, 1], got {t!r} in "
                f"{tuple(cfg.matching.thresholds)}"
            )
    if cfg.train.grad_accum_steps < 1:
        raise ValueError(
            f"train.grad_accum_steps must be >= 1, got "
            f"{cfg.train.grad_accum_steps}")
    if cfg.data.max_detections > max(cfg.data.bucket_sizes):
        # Loaders cap each image to max_detections BY SCORE; anything
        # still above the largest bucket would then be truncated by
        # make_batch's input-order prefix — silently dropping
        # high-scoring detections and desyncing rescore_roidb's output
        # length from the record's num_dets.
        raise ValueError(
            f"data.max_detections={cfg.data.max_detections} exceeds the "
            f"largest bucket {max(cfg.data.bucket_sizes)}; raise "
            "data.bucket_sizes or lower data.max_detections")
    ew = cfg.model.pair_elementwise_dtype
    if ew not in ("float32", "bfloat16"):
        raise ValueError(f"pair_elementwise_dtype must be float32 or "
                         f"bfloat16, got {ew!r}")
    if ew == "bfloat16" and cfg.model.pair_matmul_dtype != "bfloat16":
        raise ValueError(
            "pair_elementwise_dtype=bfloat16 requires "
            "pair_matmul_dtype=bfloat16 (the pair dots must produce the "
            "bf16 streamed tensors directly; a bf16 elementwise stage "
            "under f32 dots would silently discard the f32 precision "
            "the config asked for)")


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
