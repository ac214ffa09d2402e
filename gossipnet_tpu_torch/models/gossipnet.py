"""GossipNet in PyTorch (port of ``gossipnet_tpu/models/gossipnet.py``).

Per image with N detections and neighbour set E = {(i,j): IoU >= 0.2}
(self-pairs included), K stacked residual blocks:

    r_i    = relu(FC_reduce(c_i))                   128 -> 32
    a_i    = r_i @ Wa + b1,  b_j = r_j @ Wb
    m_i    = max_{j in E(i)} relu(W2^T relu(a_i + b_j + g_ij @ Wg) + b2)
    c_i   += FC_out(relu(FC_expand(m_i)))            32 -> 128
    logit_i = FC_head(c_K,i); padding gets PAD_LOGIT

``pool_impl``: "dense" materializes the pair tensor (row-chunked);
"kernel" streams it through a pair kernel: ``pair_kernel: 2`` is K1, with
K2 as its backward (``ops/cuda/pairwise2.py``), ``pair_kernel: 1`` is K5,
with K6 (``ops/cuda/pairwise.py``); on CPU tensors each is its plain
version. ``num_classes > 1`` adds the class embedding to the input
features, ranks scores within each class and gives the pair stage a ninth
feature, the class match.
``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), the JAX model's ``nn.remat``. The kernel
path sorts detections by Morton key first and unsorts the logits (a pure
speed transform: the network is permutation-equivariant per detection).

Reduced precision, as the JAX model has it. ``model.dtype: bfloat16``
rounds boxes and scores to bf16 at the model boundary; the Morton key, the
detection columns, the dense path's pair tensor, the rank feature and the
class embedding are then computed in bf16, and ``init_fc``, the blocks and
the head run in float32 on those values (flax promotes a bf16 input
against float32 weights). ``pair_elementwise_dtype: bfloat16`` streams K1's
and K2's h1, pre2 and running max in bf16; the dense path and
``pair_kernel: 1`` ignore it, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor, nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from gossipnet_tpu_torch.config import ModelConfig
from gossipnet_tpu_torch.ops import order as ordering
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops import ranking
from gossipnet_tpu_torch.ops.cuda import pairwise, pairwise2
from gossipnet_tpu_torch.ops.cuda.launch import check_tile

NEG_INF = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PAD_LOGIT = -1e4  # logit assigned to padded detections at the head
POOL_IMPLS = ("dense", "kernel")
_CHUNK_ELEMENTS = 1 << 25   # pair activations per row chunk of the dense path


class PairParams(NamedTuple):
    """Pair-stage parameters of one block, shared by both pool paths."""

    wa: Tensor   # [R, P]  r_i path of pair FC1
    wb: Tensor   # [R, P]  r_j path of pair FC1
    wg: Tensor   # [G, P]  pair-feature path of FC1
    b1: Tensor   # [P]
    w2: Tensor   # [P, P]  pair FC2 (in, out)
    b2: Tensor   # [P]


def check_supported(cfg: ModelConfig, pool_impl: str) -> None:
    """Raise on the config values this port cannot honour."""
    if pool_impl not in POOL_IMPLS:
        raise ValueError(f"unknown pool_impl {pool_impl!r}; "
                         f"options: {POOL_IMPLS}")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"model.dtype must be one of {tuple(DTYPES)}, "
                         f"got {cfg.dtype!r}")


def resolve_device(device) -> torch.device:
    """The device a model runs on; a CUDA device must exist (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch path instead")
    return device


def pair_pool_dense(a: Tensor, b: Tensor, wg: Tensor, w2: Tensor, b2: Tensor,
                    g: Tensor, mask: Tensor) -> Tensor:
    """Dense pair stage + neighbour max -> m [..., N, P] (0 for a row
    without neighbours). Materializes [..., rows, N, P] in row chunks of
    at most ``_CHUNK_ELEMENTS`` activations.

    a [..., N, P]; b [..., N, P]; g [..., N, N, G]; mask [..., N, N].
    """
    n, p = a.shape[-2], a.shape[-1]
    lead = 1
    for d in a.shape[:-2]:
        lead *= d
    chunk = max(1, _CHUNK_ELEMENTS // max(lead * n * p, 1))
    out = torch.empty_like(a)
    for r0 in range(0, n, chunk):
        rows = slice(r0, r0 + chunk)
        # a bf16 g (model.dtype bfloat16) is promoted against wg, as in JAX
        u1 = (a[..., rows, None, :] + b[..., None, :, :]
              + g[..., rows, :, :].to(wg.dtype) @ wg)
        h2 = torch.relu(torch.relu(u1) @ w2 + b2)
        h2 = torch.where(mask[..., rows, :, None], h2,
                         torch.full_like(h2, NEG_INF))
        m = h2.amax(dim=-2)
        out[..., rows, :] = torch.where(m <= NEG_INF / 2,
                                        torch.zeros_like(m), m)
    return out


def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    # skip_init: parameters are always loaded (params.py), never drawn
    # from torch's global generator.
    return skip_init(nn.Linear, fan_in, fan_out, device=device)


class GossipBlock(nn.Module):
    """One gossip block: reduce -> pair MLP -> neighbour max -> expand."""

    def __init__(self, cfg: ModelConfig, num_pair_features: int, device):
        super().__init__()
        fd, rd, p = cfg.feature_dim, cfg.reduced_dim, cfg.pairwise_dim
        self.reduce = _linear(fd, rd, device)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.pair_wa = param(rd, p)
        self.pair_wb = param(rd, p)
        self.pair_wg = param(num_pair_features, p)
        self.pair_b1 = param(p)
        self.pair_w2 = param(p, p)
        self.pair_b2 = param(p)
        # expand_hidden_layers-1 relu FCs of width P (named as in the
        # flax model: expand, expand_h1, ...), then the map to feature_dim.
        self.expand_names = []
        for i in range(cfg.expand_hidden_layers - 1):
            name = "expand" if i == 0 else f"expand_h{i}"
            setattr(self, name, _linear(p, p, device))
            self.expand_names.append(name)
        self.expand_out = _linear(p, fd, device)

    def pair_params(self) -> PairParams:
        return PairParams(self.pair_wa, self.pair_wb, self.pair_wg,
                          self.pair_b1, self.pair_w2, self.pair_b2)

    def forward(self, c: Tensor, pool_fn, gather=None) -> Tensor:
        """``gather`` joins this rank's rows of r into every detection's
        (a det-sharded forward; None: c holds every row)."""
        r = torch.relu(self.reduce(c))
        prm = self.pair_params()
        a = r @ prm.wa + prm.b1
        b = (r if gather is None else gather(r)) @ prm.wb
        e = pool_fn(prm, a, b)
        for name in self.expand_names:
            e = torch.relu(getattr(self, name)(e))
        return c + self.expand_out(e)


class GossipNet(nn.Module):
    """Rescoring network over a batch of padded detection sets.

    Inputs: boxes [B, N, 4] xyxy, scores [B, N], valid [B, N] bool,
    classes [B, N] int (multi-class only). Output: logits [B, N]; padded
    entries get PAD_LOGIT. Parameters are created uninitialised; load them
    with ``load_state_dict`` (see ``params.py``). ``remat`` rematerialises
    each block in the backward (trades recompute for activation memory;
    with the kernel path the recompute launches the pair kernel again).
    ``pair_tile``: the pair kernels' skip tile (FI, TJ), one of
    ``ops/cuda/launch.py`` TILES (``None``: ``launch.DEFAULT_TILE``); the
    flags are built at it and every launch takes it, the det-sharded
    forward's row shards too. The result does not depend on it. The
    config's ``pair_tile_i/j`` are the TPU kernel's block and do not reach
    the card.
    """

    def __init__(self, cfg: ModelConfig, pool_impl: str = "dense",
                 device="cuda", remat: bool = False, pair_tile=None):
        super().__init__()
        check_supported(cfg, pool_impl)
        self.pair_tile = check_tile(pair_tile)
        device = resolve_device(device)
        # "float32" means IEEE f32, as the JAX side forces with
        # Precision.HIGHEST: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.pool_impl = pool_impl
        self.remat = remat
        self.multiclass = cfg.num_classes > 1
        num_g = (pf.NUM_PAIR_FEATURES_MC if self.multiclass
                 else pf.NUM_PAIR_FEATURES)
        phi_dim = 1 + int(cfg.score_rank_feature)
        if self.multiclass:
            self.class_embed = skip_init(nn.Embedding, cfg.num_classes,
                                         cfg.class_embed_dim, device=device)
            phi_dim += cfg.class_embed_dim
        self.init_fc = _linear(phi_dim, cfg.feature_dim, device)
        self.blocks = nn.ModuleList(
            GossipBlock(cfg, num_g, device) for _ in range(cfg.num_blocks))
        self.head = _linear(cfg.feature_dim, 1, device)

    def _pool_fn(self, cols: pf.DetColumns, classes: Tensor | None,
                 pool_impl: str, own):
        """The pair stage of every block: the rows ``own`` keeps of these
        detections against all of them."""
        cfg = self.cfg
        if pool_impl == "dense":
            g, mask = pf.dense_pair_tensor(cols, cfg.neighbor_iou, classes)

            def pool_fn(prm: PairParams, a, b):
                return pair_pool_dense(a, b, prm.wg, prm.w2, prm.b2, g, mask)
            return pool_fn
        col = pf.stack_columns(cols)
        row = own(col, 2).contiguous()
        kernel, build = ((pairwise2, pairwise2.pair_geometry)
                         if cfg.pair_kernel == 2
                         else (pairwise, pairwise.pair_columns))
        geom = build(row, col, cfg.neighbor_iou,
                     None if classes is None else own(classes), classes,
                     block_sparse=cfg.block_sparse, tile=self.pair_tile)

        # the bf16 stream is K1/K2's alone: K5/K6 ignore it, as v1 does
        kw = ({"elementwise_dtype": cfg.pair_elementwise_dtype}
              if cfg.pair_kernel == 2 else {})

        def pool_fn(prm: PairParams, a, b):
            return kernel.pair_pool(
                row, col, a, b, prm, cfg.neighbor_iou,
                compute_dtype=cfg.pair_matmul_dtype,
                block_sparse=cfg.block_sparse, geometry=geom, **kw)
        return pool_fn

    def forward(self, boxes: Tensor, scores: Tensor, valid: Tensor,
                classes: Tensor | None = None, *, mesh=None) -> Tensor:
        """``mesh`` (a ``parallel.world.Mesh``) shards the pair stage's
        rows over its 'det' axis: this rank keeps NR = N / n_det rows of
        every per-detection tensor and pools them against all N
        detections through the pair kernel, whatever ``pool_impl`` says;
        each block gathers r, and the logits are gathered at the end, so
        every det rank returns the same [B, N] (``parallel/spmd.py``).
        The inputs are then the same on every det rank. At one shard, or
        with no mesh, nothing is sliced or gathered."""
        cfg = self.cfg
        if self.multiclass and classes is None:
            raise ValueError("multi-class model requires `classes`")
        dtype = DTYPES[cfg.dtype]
        boxes = boxes.to(dtype)
        scores = scores.to(dtype)
        valid = valid.bool()
        classes = classes if self.multiclass else None
        pool_impl = self.pool_impl if mesh is None else "kernel"
        shards = 1 if mesh is None else mesh.shape["det"]
        n = scores.shape[-1]
        if n % shards:
            raise ValueError(f"{n} detections do not split over {shards} "
                             "det shards")
        rows = n // shards
        start = 0 if mesh is None else mesh.det_rank * rows

        def own(x: Tensor, dim: int = 1) -> Tensor:
            return x if shards == 1 else x.narrow(dim, start, rows)

        gather = None if shards == 1 else mesh.gather_rows

        # a mesh sorts the replicated inputs: every rank finds the same
        # permutation, so the row slices agree
        inv_perm = None
        if pool_impl == "kernel" and cfg.sort_detections:
            key = ordering.morton_sort_key(boxes, valid)
            perm = torch.argsort(key, dim=-1, stable=True)
            inv_perm = torch.argsort(perm, dim=-1)
            boxes = torch.gather(boxes, -2, perm[..., None].expand_as(boxes))
            scores = torch.gather(scores, -1, perm)
            valid = torch.gather(valid, -1, perm)
            if classes is not None:
                classes = torch.gather(classes, -1, perm)

        cols = pf.det_columns(boxes, scores, valid)
        phi = [own(scores)[..., None]]
        if cfg.score_rank_feature:
            # the rank runs over every detection, then keeps the own rows
            phi.append(own(ranking.score_rank(scores, valid, classes,
                                              cfg.num_classes))
                       .to(dtype)[..., None])
        if classes is not None:
            # flax's Embed(dtype=...) casts the table before the lookup, so
            # its gradient arrives as the bf16 cotangent's sum. The lookup
            # is a one-hot product (exact: one 1 a row) because its backward
            # then sums each class's rows in a GEMM, in a fixed order; the
            # CUDA embedding backward sums them with atomics, so two runs of
            # one step would differ in the last bits
            onehot = own(classes).long()[..., None] == torch.arange(
                cfg.num_classes, device=classes.device)
            phi.append(onehot.to(dtype) @ self.class_embed.weight.to(dtype))
        # init_fc and everything after it run in float32 (flax promotes a
        # bf16 input against float32 weights)
        c = self.init_fc(torch.cat(phi, dim=-1).float())

        pool_fn = self._pool_fn(cols, classes, pool_impl, own)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # the recompute gathers again
                c = checkpoint(block, c, pool_fn, gather,
                               use_reentrant=False)
            else:
                c = block(c, pool_fn, gather)

        logits = self.head(c)[..., 0]
        logits = torch.where(own(valid), logits,
                             torch.full_like(logits, PAD_LOGIT))
        if gather is not None:
            logits = gather(logits)
        if inv_perm is not None:
            logits = torch.gather(logits, -1, inv_perm)
        return logits


def rescore(model: GossipNet, boxes: Tensor, scores: Tensor, valid: Tensor,
            classes: Tensor | None = None) -> Tensor:
    """Functional forward: new logits for ranking/thresholding (no grad)."""
    with torch.inference_mode():
        return model(boxes, scores, valid, classes)
