"""K5 and K6, the unfolded pair-pool forward and backward: CUDA kernel
wrappers, their plain versions and the autograd Function that joins them
(port of ``gossipnet_tpu/ops/pallas/pairwise.py``, the model's
``pair_kernel: 1``).

The pair stage of a gossip block is

    m_i = max(0, max_{j in E(i)} W2^T relu(a_i + b_j + g_ij @ Wg) + b2)

over the neighbour set E(i) = {j : IoU(i, j) >= neighbor_iou, both valid}.
It is the function K1 computes (``pairwise2.py``), but nothing is folded:
a = r @ Wa + b1 and b = r @ Wb go in as they are, and K5
(``csrc/pairwise_fwd.cu``) computes all 8 pair features of
:func:`pf.pair_feature_list` (9 with the class match) per pair from the
stacked DetColumns. K6 (``csrc/pairwise_bwd.cu``) is its recompute
backward; the gradient of every row of Wg leaves it directly. Both skip
whole tiles whose row and column bounding boxes do not meet, with K1's
rule (:func:`pairwise2.tile_activity`) at a skip tile of ``launch.TILES``.

Both run on K1's and K2's design and code (``csrc/pair_group.cuh``,
``csrc/pairwise2_pair.cuh``): stage A tests every pair of an active tile,
one per lane, and queues the neighbours with their nine features; stage B
runs FC1 and FC2 on full groups of queued pairs, FC2 on the tensor cores
in bf16 mode; K5's running max is an order-free integer merge, so several
blocks share a row tile (:func:`launch.col_splits`); K6 sums d_a and the
weight gradients in a pass over the rows and d_b in a pass over the
columns, each in a fixed order, with no dense partial. Only the fields,
the neighbour test and the features are K5's own
(``csrc/pairwise_pair.cuh``): they are what keeps K5 an oracle for K1.

bf16 mode rounds where the TPU kernel rounds: the features, Wg, h1 and W2;
a, b and b2 stay f32 (K1 rounds its b' as well, so bf16 K5 and bf16 K1
differ; in f32 they agree). The TPU kernel's ``packed`` kron weights are a
TPU-only MXU option with no counterpart here.

:func:`pair_pool` routes by device: CPU tensors run the plain forward and
the plain backward (:func:`_reference_core`,
:func:`pair_pool_backward_reference`) through :class:`PairPool1`, CUDA
tensors launch K5 and K6 or raise. The plain versions repeat the kernels'
CUDA-core arithmetic, their fused multiply-adds included
(``pairwise2._fma``): in float32 they equal the kernels bit for bit and
find the same winners; in bfloat16 the kernels' FC2 sums in the tensor
cores' order, so m agrees to the stated tolerance and each side finds the
winners of its own m.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import launch, pairwise2
from gossipnet_tpu_torch.ops.cuda.launch import (
    DEFAULT_TILE,
    TILE_I,  # noqa: F401 -- the default tile, named here as pairwise2 does
    TILE_J,  # noqa: F401
    check_dtype,
    check_inputs,
    check_packable,
    check_tile,
    forward_launch,
    kernel_mode,
)
from gossipnet_tpu_torch.ops.cuda.pairwise2 import _fma, _rounder

_VALID = pf.DetColumns._fields.index("valid")   # 13
_CLASS = pf.NUM_COLUMNS                          # the appended class field
_CHUNK_ELEMENTS = 1 << 25   # pair activations per row chunk of the plain version


class PairColumns(NamedTuple):
    """What K5 reads that depends only on the detections: built once per
    forward and shared by every block."""

    row: Tensor       # [B, C, NR] stacked DetColumns (+ class), float32
    col: Tensor       # [B, C, NC]
    flags: Tensor     # [B, NR/FI, NC/TJ] int32 tile activity at `tile`
    neighbor_iou: float
    tile: tuple = DEFAULT_TILE   # (FI, TJ), one of launch.TILES

    @property
    def num_features(self) -> int:
        return (pf.NUM_PAIR_FEATURES_MC if self.row.shape[1] > pf.NUM_COLUMNS
                else pf.NUM_PAIR_FEATURES)


def pair_columns(row_cols: Tensor, col_cols: Tensor, neighbor_iou: float,
                 classes: Tensor | None = None,
                 col_classes: Tensor | None = None,
                 block_sparse: bool = True,
                 tile: tuple | None = None) -> PairColumns:
    """K5's inputs from stacked DetColumns [B, 14, N] (rows and columns may
    differ, as for a row shard); ``classes`` appends the class as field 14
    (``col_classes`` defaults to it, the square case); ``tile`` the flags'
    skip tile, as :func:`pairwise2.pair_geometry` takes it."""
    fi, tj = check_tile(tile)
    row, col = row_cols.float(), col_cols.float()
    if classes is not None:
        col_classes = classes if col_classes is None else col_classes
        row = torch.cat([row, classes.float()[:, None]], dim=1)
        col = torch.cat([col, col_classes.float()[:, None]], dim=1)
    row, col = row.contiguous(), col.contiguous()
    if block_sparse and neighbor_iou > 0.0:
        flags = pairwise2.tile_activity(row, col, fi, tj, valid_field=_VALID)
    else:
        b, nr, nc = row.shape[0], row.shape[2], col.shape[2]
        flags = torch.ones((b, -(-nr // fi), -(-nc // tj)),
                           dtype=torch.int32, device=row.device)
    return PairColumns(row, col, flags.contiguous(), float(neighbor_iou),
                       (fi, tj))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _pair_chunks(cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                 w2: Tensor, b2bias: Tensor, compute_dtype: str):
    """Every (row, column) pair in row chunks of at most
    ``_CHUNK_ELEMENTS`` activations, with the kernels' arithmetic: yields
    (rows, nb [B, rc, NC], g [B, rc, NC, G], h1 [B, rc, NC, P],
    pre2 [B, rc, NC, P]). The features are :func:`pf.pair_feature_list`
    (one IEEE op each, as csrc/pairwise_pair.cuh computes them); FC1 and
    FC2 run as the kernels' fmaf chains in their order, rounding in bf16
    mode where they round, so in float32 pre2 equals the kernels' bit for
    bit and the backward finds K5's winners (bf16: the kernels' FC2 runs on
    the tensor cores, equal to tolerance)."""
    rnd = _rounder(compute_dtype)
    row, col = cols.row, cols.col
    bsz, _, nr = row.shape
    nc = col.shape[2]
    p = a.shape[-1]
    ng = cols.num_features
    wgr, w2r = rnd(wg.float()), rnd(w2.float())
    bj = b.float()[:, None, :, :]                        # [B, 1, NC, P]
    thr = torch.tensor(cols.neighbor_iou, dtype=torch.float32,
                       device=row.device)
    cj = pf.DetColumns(*col[:, :pf.NUM_COLUMNS, None, :].unbind(1))
    chunk = max(1, _CHUNK_ELEMENTS // max(bsz * nc * p, 1))
    for r0 in range(0, nr, chunk):
        rows = slice(r0, min(r0 + chunk, nr))
        ri = row[:, :, rows, None]                       # [B, C, rc, 1]
        ci = pf.DetColumns(*ri[:, :pf.NUM_COLUMNS].unbind(1))
        iou = pf.pair_iou(ci, cj)
        nb = (iou >= thr) & (ci.valid > 0.0) & (cj.valid > 0.0)
        match = None
        if ng == pf.NUM_PAIR_FEATURES_MC:
            match = ri[:, _CLASS] == col[:, _CLASS, None, :]
        g = rnd(torch.stack(pf.pair_feature_list(ci, cj, iou=iou,
                                                 class_match=match), dim=-1))
        h = bj.expand(bsz, rows.stop - r0, nc, p)
        for f in range(ng):
            h = _fma(g[..., f:f + 1], wgr[f], h)
        h1 = rnd(torch.clamp(a.float()[:, rows, None, :] + h, min=0.0))
        pre2 = b2bias.float().expand_as(h1)
        for i in range(p):                               # FC2 input index
            pre2 = _fma(h1[..., i:i + 1], w2r[i], pre2)
        yield rows, nb, g, h1, pre2


def _reference_core(cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                    w2: Tensor, b2bias: Tensor, compute_dtype: str) -> Tensor:
    """K5's arithmetic in torch -> m [B, NR, P] float32."""
    bsz, nr, p = a.shape
    out = torch.empty((bsz, nr, p), dtype=torch.float32, device=a.device)
    for rows, nb, _, _, pre2 in _pair_chunks(cols, a, b, wg, w2, b2bias,
                                             compute_dtype):
        pre2 = torch.where(nb[..., None], pre2, torch.zeros_like(pre2))
        out[:, rows] = torch.clamp(pre2.amax(dim=2), min=0.0)
    return out


def pair_pool_backward_reference(cols: PairColumns, a: Tensor, b: Tensor,
                                 wg: Tensor, w2: Tensor, b2bias: Tensor,
                                 m: Tensor, dm: Tensor, compute_dtype: str):
    """K6's arithmetic in torch: the VJP of K5 from its output m ->
    (d_a [B, NR, P], d_b [B, NC, P], dWg [G, P], dW2 [P, P], db2 [P]).

    Recomputes pre2 with :func:`_pair_chunks` and routes dm[i, q] to every
    neighbour j with pre2_ij[q] == m_i[q] > 0: each exact tie gets the
    full gradient (``pairwise.py::_tile_backward_core``). bf16 mode rounds
    the operands of the TPU backward's dots (dpre2 and W2; dpre1 and g; h1
    and dpre2); d_a, d_b and db2 sum unrounded. The CPU backward of
    :class:`PairPool1` and K6's oracle.
    """
    rnd = _rounder(compute_dtype)
    f32 = dict(dtype=torch.float32, device=a.device)
    da = torch.zeros(a.shape, **f32)
    db = torch.zeros(b.shape, **f32)
    dwg = torch.zeros(wg.shape, **f32)
    dw2 = torch.zeros(w2.shape, **f32)
    db2 = torch.zeros(b2bias.shape, **f32)
    dmg = torch.where(m > 0.0, dm.float(), torch.zeros_like(m))
    w2r = rnd(w2.float())
    for rows, nb, g, h1, pre2 in _pair_chunks(cols, a, b, wg, w2, b2bias,
                                              compute_dtype):
        win = nb[..., None] & (pre2 == m[:, rows, None, :])
        dp2 = torch.where(win, dmg[:, rows, None, :], torch.zeros_like(pre2))
        dp1 = torch.where(h1 > 0.0, rnd(dp2) @ w2r.T, torch.zeros_like(h1))
        da[:, rows] = dp1.sum(dim=2)
        db += dp1.sum(dim=1)
        dp1 = rnd(dp1)
        dwg += torch.einsum("bijp,bijk->kp", dp1, g)
        dw2 += torch.einsum("bijp,bijq->pq", h1, rnd(dp2))
        db2 += dp2.sum(dim=(0, 1, 2))
    return da, db, dwg, dw2, db2


def pair_pool_reference(row_cols: Tensor, col_cols: Tensor, a: Tensor,
                        b: Tensor, pair_params, neighbor_iou: float,
                        classes: Tensor | None = None,
                        col_classes: Tensor | None = None,
                        compute_dtype: str = "bfloat16") -> Tensor:
    """Plain PyTorch K5 on any device -> m [B, NR, P] float32. Same
    arguments as :func:`pair_pool`; the kernel's oracle on the card."""
    check_dtype(compute_dtype)
    cols = pair_columns(row_cols, col_cols, neighbor_iou, classes,
                        col_classes)
    return _reference_core(cols, a, b, pair_params.wg, pair_params.w2,
                           pair_params.b2, compute_dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


_LAYOUTS = ((pf.NUM_PAIR_FEATURES, pf.NUM_COLUMNS),
            (pf.NUM_PAIR_FEATURES_MC, pf.NUM_COLUMNS + 1))


def launch_kernel(cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                  w2: Tensor, b2bias: Tensor, compute_dtype: str) -> Tensor:
    """One K5 launch on the current stream -> m [B, NR, P] float32.

    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take; raises if the launch is refused.
    """
    check_inputs("K5", cols, a, b, wg, w2, b2bias, compute_dtype, _LAYOUTS)
    check_packable("K5", cols)
    out = forward_launch("pairwise_fwd", "K5", "gnet_pair_pool_fwd",
                          "gnet_pair_pool_tiles", cols, a, b, wg, w2, b2bias,
                          compute_dtype)
    pair_pool.launches += 1
    return out


def launch_backward_kernel(cols: PairColumns, a: Tensor, b: Tensor,
                           wg: Tensor, w2: Tensor, b2bias: Tensor, m: Tensor,
                           dm: Tensor, compute_dtype: str):
    """One K6 launch on the current stream -> (d_a, d_b, dWg, dW2, db2)
    float32, as :func:`pair_pool_backward_reference` returns them, summed
    from the kernel's partials in a fixed order (two launches give the
    same bits)."""
    check_inputs("K6", cols, a, b, wg, w2, b2bias, compute_dtype, _LAYOUTS,
                  m=m, dm=dm)
    check_packable("K6", cols)
    grads = backward_launch(cols, a, b, wg, w2, b2bias, m, dm,
                            compute_dtype)
    pair_pool_backward.launches += 1
    return grads


def backward_launch(cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                    w2: Tensor, b2bias: Tensor, m: Tensor, dm: Tensor,
                    compute_dtype: str):
    """K6 -> (d_a, d_b, dWg, dW2, db2) float32; inputs already checked.
    The kernel takes the splits S (``launch.col_splits``) and two scratch
    tensors [S, B, NR, P] and [S, B, NC, P], one slice per split, which it
    adds in order into d_a and d_b itself (none for one split); its weight
    partials leave per block of 32 rows and split and are summed here."""
    bsz, nr, p = a.shape
    nc, g, ni = b.shape[1], wg.shape[0], -(-nr // launch.BLOCK_ROWS)
    f32 = dict(dtype=torch.float32, device=a.device)
    s = launch._splits(cols, a.device, whole_matrix=True)
    da = torch.empty((bsz, nr, p), **f32)
    db = torch.empty((bsz, nc, p), **f32)
    scratch = (torch.empty((s if s > 1 else 0, bsz, nr, p), **f32),
               torch.empty((s if s > 1 else 0, bsz, nc, p), **f32))
    parts = (torch.empty((s * bsz * ni, g, p), **f32),
             torch.empty((s * bsz * ni, p, p), **f32),
             torch.empty((s * bsz * ni, p), **f32))
    launch._launch("pairwise_bwd", "K6", "gnet_pair_pool_bwd",
                   "gnet_pair_pool_bwd_tiles", cols,
                   (cols.row, cols.col, a, b, wg, w2, b2bias, cols.flags, m,
                    dm, da, db, *scratch, *parts), p, g, s,
                   kernel_mode(compute_dtype))
    return (da, db, *(t.sum(dim=0) for t in parts))


def pair_pool_backward(cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                       w2: Tensor, b2bias: Tensor, m: Tensor, dm: Tensor,
                       compute_dtype: str):
    """The pair stage's VJP -> (d_a, d_b, dWg, dW2, db2): the plain
    version on CPU tensors, K6 on CUDA tensors (or raise)."""
    if a.device.type == "cpu":
        return pair_pool_backward_reference(cols, a, b, wg, w2, b2bias, m,
                                            dm, compute_dtype)
    return launch_backward_kernel(cols, a, b, wg, w2, b2bias, m, dm,
                                  compute_dtype)


pair_pool_backward.launches = 0   # K6 launches; only launch_backward_kernel adds


class PairPool1(torch.autograd.Function):
    """m = pair stage of (a, b) with K5 as forward and K6 as backward
    (port of ``_pair_pool_p.defvjp``, ``pairwise.py:656-676``).

    Saves its inputs and m and recomputes the pairs in the backward, as
    the TPU kernel does; every input but the detection columns gets its
    gradient from K6.
    """

    @staticmethod
    def forward(ctx, cols: PairColumns, a: Tensor, b: Tensor, wg: Tensor,
                w2: Tensor, b2bias: Tensor, compute_dtype: str) -> Tensor:
        if a.device.type == "cpu":
            m = _reference_core(cols, a, b, wg, w2, b2bias, compute_dtype)
        else:
            m = launch_kernel(cols, a, b, wg, w2, b2bias, compute_dtype)
        ctx.cols, ctx.compute_dtype = cols, compute_dtype
        ctx.save_for_backward(a, b, wg, w2, b2bias, m)
        return m

    @staticmethod
    def backward(ctx, dm: Tensor):
        a, b, wg, w2, b2bias, m = ctx.saved_tensors
        grads = pair_pool_backward(ctx.cols, a, b, wg, w2, b2bias, m,
                                   dm.contiguous(), ctx.compute_dtype)
        return (None, *grads, None)


def pair_pool(row_cols: Tensor, col_cols: Tensor, a: Tensor, b: Tensor,
              pair_params, neighbor_iou: float,
              classes: Tensor | None = None,
              col_classes: Tensor | None = None,
              compute_dtype: str = "bfloat16", block_sparse: bool = True,
              geometry: PairColumns | None = None) -> Tensor:
    """Pair stage m [B, NR, P] float32 of one block, differentiable
    (``pallas_pair_pool_rect`` / ``pallas_pair_pool``; NR != NC allowed).

    row_cols [B, 14, NR] / col_cols [B, 14, NC]: stacked DetColumns.
    a [B, NR, P] = r @ Wa + b1 (rows); b [B, NC, P] = r @ Wb (columns);
    ``pair_params`` has ``wg`` [G, P], ``w2`` [P, P] (in, out) and ``b2``
    [P], G = 9 with ``classes``. ``geometry`` (from :func:`pair_columns`)
    skips rebuilding the detection-only inputs; a model builds it once per
    forward.

    CPU tensors take the plain forward and backward (``block_sparse`` is
    exact, so it changes nothing there). CUDA tensors launch K5, and K6
    in the backward, or raise.
    """
    if a.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"pair_pool runs on cpu or cuda, got {a.device}")
    check_dtype(compute_dtype)
    cols = geometry or pair_columns(row_cols, col_cols, neighbor_iou,
                                    classes, col_classes, block_sparse)
    return PairPool1.apply(cols, a.float().contiguous(),
                           b.float().contiguous(),
                           pair_params.wg.float().contiguous(),
                           pair_params.w2.float().contiguous(),
                           pair_params.b2.float().contiguous(), compute_dtype)


pair_pool.launches = 0   # K5 launches; only launch_kernel adds to it
