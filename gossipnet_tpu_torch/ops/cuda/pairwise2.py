"""K1 and K2, the pair-pool forward and backward: CUDA kernel wrappers,
their plain versions, and the preparation they share (port of ``gossipnet_tpu/ops/pallas/pairwise2.py``).

The pair stage of a gossip block is

    m_i = max(0, max_{j in E(i)} W2^T relu(a_i + b_j + g_ij @ Wg) + b2)

over the neighbour set E(i) = {j : IoU(i, j) >= neighbor_iou, both valid}.
As on the TPU, five of the eight pair features are additively separable,
so their Wg rows fold into a and b before the kernel
(:func:`fold_separable`, O(N) torch matmuls). The kernel then computes
three features per pair (four with the class match) and skips whole tiles
whose row and column bounding boxes do not meet (:func:`tile_activity`;
exact for neighbor_iou > 0). It tests every pair of an active tile, one
per lane, queues the neighbours, and runs the two products on full groups
of queued pairs, FC2 on the tensor cores in bf16 mode; the running max is
an order-free integer merge, so several blocks share a row tile
(``csrc/pairwise2_fwd.cu``, ``csrc/pair_group.cuh``). Nothing of the
TPU's layout (sublane packing, kron weights, quadrant splits) carries
over.

K2 is its backward (``csrc/pairwise2_bwd.cu``): it recomputes every
neighbour pair from the saved output m through the same queue and product
and routes dm to the max winners, each exact tie getting the full
gradient as the TPU kernel's VJP does; a pass over the rows sums d_a' and
the weight gradients, a pass over the columns d_b', each in a fixed
order. :class:`PairPool2` joins the two as one
``torch.autograd.Function``.

:func:`pair_pool` routes by device: CPU tensors run the plain forward and
the plain backward (:func:`_reference_core`,
:func:`pair_pool_backward_reference`) through the same Function, CUDA
tensors launch K1 and K2 or raise. The plain versions repeat the kernels'
CUDA-core arithmetic, their fused multiply-adds included (:func:`_fma`):
in float32 they equal the kernels bit for bit and find the same winners;
in bfloat16 the kernels' FC2 sums in the tensor cores' order, so m agrees
to the stated tolerance and each side finds the winners of its own m.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda.launch import (
    DEFAULT_TILE,
    TILE_I,
    TILE_J,
    backward_launch,
    check_dtype,
    check_inputs,
    check_packable,
    check_tile,
    forward_launch,
)

# Wg rows folded into the row (a) / column (b) terms outside the kernel,
# and the rows kept in the kernel (pair_features.py order).
_SEP_I = (1, 2, 3, 4, 5, 6)   # dx_i-half, dy_i-half, -dlogs, s_i
_SEP_J = (3, 4, 5, 7)         # +dlogs, s_j
_KERNEL_ROWS = (0, 1, 2)      # iou, cx_j * inv_w_i, cy_j * inv_h_i
_KERNEL_ROWS_MC = (0, 1, 2, 8)  # + class-match

# Field order of the kernel's row and column inputs (csrc comment).
_CI_FIELDS = ("x1", "y1", "x2", "y2", "area", "inv_w", "inv_h", "valid")
_CJ_FIELDS = ("x1", "y1", "x2", "y2", "area", "cx", "cy", "valid")
_VALID = 7

_CHUNK_ELEMENTS = 1 << 25   # pair activations per row chunk of the plain version


class PairGeometry(NamedTuple):
    """What K1 reads that depends only on the detections: built once per
    forward and shared by every block."""

    row: Tensor       # [B, CI, NR] row fields (_CI_FIELDS [+ class])
    col: Tensor       # [B, CJ, NC] column fields (_CJ_FIELDS [+ class])
    i_feats: Tensor   # [B, NR, 6] separable row-side features
    j_feats: Tensor   # [B, NC, 4] separable column-side features
    flags: Tensor     # [B, NR/FI, NC/TJ] int32 tile activity at `tile`
    neighbor_iou: float
    tile: tuple = DEFAULT_TILE   # (FI, TJ), one of launch.TILES

    @property
    def multiclass(self) -> bool:
        return self.row.shape[1] == len(_CI_FIELDS) + 1


def tile_activity(row: Tensor, col: Tensor, ti: int = TILE_I,
                  tj: int = TILE_J, valid_field: int = _VALID) -> Tensor:
    """Per tile pair flags, int32 [B, ceil(NR/ti), ceil(NC/tj)].

    A tile pair is inactive when the bounding boxes of its valid row and
    column detections do not meet: then no pair in it has IoU > 0, so
    skipping it is exact for neighbor_iou > 0 (``pairwise.py``
    ``_tile_activity``, at a skip tile of the CUDA kernels; the ragged
    edge pads with invalid entries). ``row`` / ``col`` hold x1, y1, x2, y2 as
    fields 0-3 and validity as field ``valid_field``.
    """
    big = 1e30

    def extent(fields: Tensor, t: int):
        valid = fields[:, valid_field] > 0.0
        pad = (-fields.shape[-1]) % t

        def reduce(x, fill, op):
            x = F.pad(torch.where(valid, x, torch.full_like(x, fill)),
                      (0, pad), value=fill)
            return op(x.reshape(x.shape[0], -1, t), dim=-1)

        return (reduce(fields[:, 0], big, torch.amin),
                reduce(fields[:, 1], big, torch.amin),
                reduce(fields[:, 2], -big, torch.amax),
                reduce(fields[:, 3], -big, torch.amax))

    rx1, ry1, rx2, ry2 = extent(row, ti)                     # [B, NI]
    cx1, cy1, cx2, cy2 = extent(col, tj)                     # [B, NJ]
    ox = (rx1[:, :, None] < cx2[:, None, :]) & (cx1[:, None, :] < rx2[:, :, None])
    oy = (ry1[:, :, None] < cy2[:, None, :]) & (cy1[:, None, :] < ry2[:, :, None])
    return (ox & oy).to(torch.int32)


def pair_geometry(row_cols: Tensor, col_cols: Tensor, neighbor_iou: float,
                  classes: Tensor | None = None,
                  col_classes: Tensor | None = None,
                  block_sparse: bool = True,
                  tile: tuple | None = None) -> PairGeometry:
    """Kernel inputs derived from stacked DetColumns [B, 14, N] (rows and
    columns may differ, as for a row shard). ``col_classes`` defaults to
    ``classes`` (the square case). ``tile``: the skip tile (FI, TJ) of the
    flags, which the launches then take (one of ``launch.TILES``; ``None``
    is ``launch.DEFAULT_TILE``; any other shape raises).

    The kernel's fields are the columns widened to float32. The fold's
    ratios -cx/w and -cy/h are divided in the columns' own dtype, as the
    JAX wrapper folds them: in bf16 for bf16 columns (``model.dtype:
    bfloat16``), except with classes, whose float32 row promotes the
    stacked columns before the fold (``pairwise2.py:944-951``)."""
    fi, tj = check_tile(tile)
    ci = pf.unstack_columns(row_cols.float())
    cj = pf.unstack_columns(col_cols.float())
    cr = ci if classes is not None else pf.unstack_columns(row_cols)
    row = [ci.x1, ci.y1, ci.x2, ci.y2, ci.area, 1.0 / ci.w, 1.0 / ci.h,
           ci.valid]
    col = [cj.x1, cj.y1, cj.x2, cj.y2, cj.area, cj.cx, cj.cy, cj.valid]
    if classes is not None:
        col_classes = classes if col_classes is None else col_classes
        row.append(classes.float())
        col.append(col_classes.float())
    row_t = torch.stack(row, dim=1).contiguous()
    col_t = torch.stack(col, dim=1).contiguous()
    i_feats = torch.stack([(-cr.cx / cr.w).float(), (-cr.cy / cr.h).float(),
                           -ci.log_w, -ci.log_h, -ci.log_aspect, ci.score],
                          dim=-1)
    j_feats = torch.stack([cj.log_w, cj.log_h, cj.log_aspect, cj.score],
                          dim=-1)
    if block_sparse and neighbor_iou > 0.0:
        flags = tile_activity(row_t, col_t, fi, tj)
    else:
        b, nr, nc = row_t.shape[0], row_t.shape[2], col_t.shape[2]
        flags = torch.ones((b, -(-nr // fi), -(-nc // tj)),
                           dtype=torch.int32, device=row_t.device)
    return PairGeometry(row_t, col_t, i_feats, j_feats, flags.contiguous(),
                        float(neighbor_iou), (fi, tj))


def _take_rows(x: Tensor, rows: tuple) -> Tensor:
    """``x[list(rows)]`` without an index tensor: each run of consecutive
    rows is a slice, and the runs are joined. An index list would be copied
    from pageable host memory to the card on every call, which a captured
    graph cannot hold."""
    runs = [[rows[0], rows[0] + 1]]
    for r in rows[1:]:
        if r == runs[-1][1]:
            runs[-1][1] = r + 1
        else:
            runs.append([r, r + 1])
    parts = [x[lo:hi] for lo, hi in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def fold_separable(wg: Tensor, a: Tensor, b: Tensor,
                   geom: PairGeometry) -> tuple[Tensor, Tensor]:
    """a' = a + i_feats @ wg[_SEP_I], b' = b + j_feats @ wg[_SEP_J], in f32."""
    wg = wg.float()
    a2 = a.float() + geom.i_feats @ _take_rows(wg, _SEP_I)
    b2 = b.float() + geom.j_feats @ _take_rows(wg, _SEP_J)
    return a2, b2


def _kernel_wg(wg: Tensor, multiclass: bool) -> Tensor:
    rows = _KERNEL_ROWS_MC if multiclass else _KERNEL_ROWS
    return _take_rows(wg.float(), rows).contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def fields_iou(row: Tensor, col: Tensor) -> Tensor:
    """:func:`pf.pair_iou` over broadcastable kernel row / column fields
    (x1, y1, x2, y2, area first, on dim 1)."""
    def box(f):
        return SimpleNamespace(x1=f[:, 0], y1=f[:, 1], x2=f[:, 2],
                               y2=f[:, 3], area=f[:, 4])

    return pf.pair_iou(box(row), box(col))


def _rounder(compute_dtype: str):
    if compute_dtype == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """The kernels' fmaf(a, b, c) on float32 tensors: a * b is exact in
    float64, so one float64 add and the cast round it (the two roundings
    disagree with one only at exact float32 midpoints, which random data
    almost never meets)."""
    return (a.double() * b.double() + c.double()).float()


def _pair_chunks(geom: PairGeometry, a2: Tensor, b2: Tensor, wg_k: Tensor,
                 w2: Tensor, b2bias: Tensor, compute_dtype: str,
                 elementwise_dtype: str = "float32"):
    """Every (row, column) pair in row chunks of at most
    ``_CHUNK_ELEMENTS`` activations, with the kernels' arithmetic: yields
    (rows, nb [B, rc, NC], g [B, rc, NC, K], h1 [B, rc, NC, P],
    pre2 [B, rc, NC, P]). FC1 and FC2 run as the kernels' fmaf chains in
    their order (csrc/pairwise2_pair.cuh), rounding in bf16 mode where they
    round, so in float32 pre2 equals the kernels' bit for bit and the
    backward finds K1's winners (bf16: the kernels' FC2 runs on the tensor
    cores, equal to tolerance).

    ``elementwise_dtype="bfloat16"`` streams h1 and pre2 in bf16 as the
    TPU kernel's bf16 scratch does (``pairwise2.py::_pair_mlp``): a' and
    the FC1 sum are rounded before their add and the sum after it; FC2
    sums from zero, is rounded, and bf16(b2) is added and rounded."""
    rnd = _rounder(compute_dtype)
    ew = _rounder(elementwise_dtype)
    row, col = geom.row, geom.col
    bsz, _, nr = row.shape
    nc = col.shape[2]
    p = a2.shape[-1]
    k = wg_k.shape[0]
    wk, w2r = rnd(wg_k.float()), rnd(w2.float())
    bj = rnd(b2)[:, None, :, :]                          # [B, 1, NC, P]
    a_ew = ew(a2)
    fc2_start = (torch.zeros_like(b2bias.float())
                 if elementwise_dtype == "bfloat16" else b2bias.float())
    thr = torch.tensor(geom.neighbor_iou, dtype=torch.float32,
                       device=row.device)
    cj = col[:, :, None, :]                              # [B, CJ, 1, NC]
    chunk = max(1, _CHUNK_ELEMENTS // max(bsz * nc * p, 1))
    for r0 in range(0, nr, chunk):
        rows = slice(r0, min(r0 + chunk, nr))
        ri = row[:, :, rows, None]                       # [B, CI, rc, 1]
        iou = fields_iou(ri, cj)
        nb = (iou >= thr) & (ri[:, _VALID] > 0.0) & (cj[:, _VALID] > 0.0)
        feats = [iou, cj[:, 5] * ri[:, 5], cj[:, 6] * ri[:, 6]]
        if geom.multiclass:
            feats.append((ri[:, 8] == cj[:, 8]).float())
        g = rnd(torch.stack(feats, dim=-1))              # [B, rc, NC, K]
        h = bj.expand(bsz, rows.stop - r0, nc, p)
        for f in range(k):
            h = _fma(g[..., f:f + 1], wk[f], h)
        h1 = rnd(torch.clamp(ew(a_ew[:, rows, None, :] + ew(h)), min=0.0))
        pre2 = fc2_start.expand_as(h1)
        for i in range(p):                               # FC2 input index
            pre2 = _fma(h1[..., i:i + 1], w2r[i], pre2)
        if elementwise_dtype == "bfloat16":
            pre2 = ew(ew(pre2) + ew(b2bias.float()))
        yield rows, nb, g, h1, pre2


def _reference_core(geom: PairGeometry, a2: Tensor, b2: Tensor, wg_k: Tensor,
                    w2: Tensor, b2bias: Tensor, compute_dtype: str,
                    elementwise_dtype: str = "float32") -> Tensor:
    """K1's arithmetic in torch -> m [B, NR, P] float32 (every entry a
    bf16 value when ``elementwise_dtype`` is bfloat16)."""
    bsz, nr, p = a2.shape
    out = torch.empty((bsz, nr, p), dtype=torch.float32, device=a2.device)
    for rows, nb, _, _, pre2 in _pair_chunks(geom, a2, b2, wg_k, w2, b2bias,
                                             compute_dtype,
                                             elementwise_dtype):
        pre2 = torch.where(nb[..., None], pre2, torch.zeros_like(pre2))
        out[:, rows] = torch.clamp(pre2.amax(dim=2), min=0.0)
    return out


def pair_pool_backward_reference(geom: PairGeometry, a2: Tensor, b2: Tensor,
                                 wg_k: Tensor, w2: Tensor, b2bias: Tensor,
                                 m: Tensor, dm: Tensor, compute_dtype: str,
                                 elementwise_dtype: str = "float32"):
    """K2's arithmetic in torch: the VJP of K1 from its output m ->
    (d_a' [B, NR, P], d_b' [B, NC, P], dWg_k [K, P], dW2 [P, P], db2 [P]).

    Recomputes pre2 with :func:`_pair_chunks` and routes dm[i, q] to every
    neighbour j with pre2_ij[q] == m_i[q] > 0: each exact tie gets the
    full gradient (``pairwise2.py::_win_grad``). bf16 mode rounds the dots'
    operands (dpre2, dpre1, g, h1, W2) as K2 does; d_a' and db2 sum
    unrounded. With ``elementwise_dtype`` bfloat16 the recomputed h1 and
    pre2 are the bf16 stream's (:func:`_pair_chunks`), so a winner is a
    pair whose bf16 pre2 equals m (``_win_grad``'s bf16 branch); exact
    ties are common there and each gets the full gradient. The CPU
    backward of :class:`PairPool2` and K2's oracle.
    """
    rnd = _rounder(compute_dtype)
    f32 = dict(dtype=torch.float32, device=a2.device)
    da = torch.zeros(a2.shape, **f32)
    db = torch.zeros(b2.shape, **f32)
    dwg = torch.zeros(wg_k.shape, **f32)
    dw2 = torch.zeros(w2.shape, **f32)
    db2 = torch.zeros(b2bias.shape, **f32)
    dmg = torch.where(m > 0.0, dm.float(), torch.zeros_like(m))
    w2r = rnd(w2.float())
    for rows, nb, g, h1, pre2 in _pair_chunks(geom, a2, b2, wg_k, w2, b2bias,
                                              compute_dtype,
                                              elementwise_dtype):
        win = nb[..., None] & (pre2 == m[:, rows, None, :])
        dp2 = torch.where(win, dmg[:, rows, None, :], torch.zeros_like(pre2))
        dp1 = torch.where(h1 > 0.0, rnd(dp2) @ w2r.T, torch.zeros_like(h1))
        da[:, rows] = dp1.sum(dim=2)
        dp1 = rnd(dp1)
        db += dp1.sum(dim=1)
        dwg += torch.einsum("bijp,bijk->kp", dp1, g)
        dw2 += torch.einsum("bijp,bijq->pq", h1, rnd(dp2))
        db2 += dp2.sum(dim=(0, 1, 2))
    return da, db, dwg, dw2, db2


def pair_pool_reference(row_cols: Tensor, col_cols: Tensor, a: Tensor,
                        b: Tensor, pair_params, neighbor_iou: float,
                        classes: Tensor | None = None,
                        col_classes: Tensor | None = None,
                        compute_dtype: str = "bfloat16",
                        geometry: PairGeometry | None = None,
                        elementwise_dtype: str = "float32") -> Tensor:
    """Plain PyTorch K1 on any device -> m [B, NR, P] float32.

    Same arguments as :func:`pair_pool`; ``pair_params`` has ``wg``
    [G, P], ``w2`` [P, P] (in, out) and ``b2`` [P]. The CPU path of
    :func:`pair_pool` and the kernel's oracle on the card.
    """
    check_dtype(compute_dtype, elementwise_dtype)
    geom = geometry or pair_geometry(row_cols, col_cols, neighbor_iou,
                                     classes, col_classes)
    a2, b2 = fold_separable(pair_params.wg, a, b, geom)
    return _reference_core(geom, a2, b2, _kernel_wg(pair_params.wg,
                                                    geom.multiclass),
                           pair_params.w2, pair_params.b2, compute_dtype,
                           elementwise_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


_LAYOUTS = ((3, len(_CI_FIELDS)), (4, len(_CI_FIELDS) + 1))


def launch_kernel(geom: PairGeometry, a2: Tensor, b2: Tensor, wg_k: Tensor,
                  w2: Tensor, b2bias: Tensor, compute_dtype: str,
                  elementwise_dtype: str = "float32") -> Tensor:
    """One K1 launch on the current stream -> m [B, NR, P] float32.

    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take; raises if the launch is refused. A bf16 stream
    (``elementwise_dtype="bfloat16"``) is its own instantiation, counted
    apart in ``pair_pool.launches_ew``.
    """
    check_inputs("K1", geom, a2, b2, wg_k, w2, b2bias, compute_dtype,
                  _LAYOUTS, elementwise_dtype=elementwise_dtype)
    check_packable("K1", geom)
    out = forward_launch("pairwise2_fwd", "K1", "gnet_pair_pool2_fwd",
                          "gnet_pair_pool2_tiles", geom, a2, b2, wg_k, w2,
                          b2bias, compute_dtype, elementwise_dtype)
    pair_pool.launches += 1
    if elementwise_dtype == "bfloat16":
        pair_pool.launches_ew += 1
    return out


def launch_backward_kernel(geom: PairGeometry, a2: Tensor, b2: Tensor,
                           wg_k: Tensor, w2: Tensor, b2bias: Tensor,
                           m: Tensor, dm: Tensor, compute_dtype: str,
                           elementwise_dtype: str = "float32"):
    """One K2 launch on the current stream -> (d_a', d_b', dWg_k, dW2, db2)
    float32, as :func:`pair_pool_backward_reference` returns them."""
    check_inputs("K2", geom, a2, b2, wg_k, w2, b2bias, compute_dtype,
                  _LAYOUTS, m=m, dm=dm, elementwise_dtype=elementwise_dtype)
    check_packable("K2", geom)
    grads = backward_launch("pairwise2_bwd", "K2", "gnet_pair_pool2_bwd",
                             "gnet_pair_pool2_bwd_tiles", geom, a2, b2, wg_k,
                             w2, b2bias, m, dm, compute_dtype,
                             elementwise_dtype)
    pair_pool_backward.launches += 1
    if elementwise_dtype == "bfloat16":
        pair_pool_backward.launches_ew += 1
    return grads


def pair_pool_backward(geom: PairGeometry, a2: Tensor, b2: Tensor,
                       wg_k: Tensor, w2: Tensor, b2bias: Tensor, m: Tensor,
                       dm: Tensor, compute_dtype: str,
                       elementwise_dtype: str = "float32"):
    """The pair stage's VJP -> (d_a', d_b', dWg_k, dW2, db2): the plain
    version on CPU tensors, K2 on CUDA tensors (or raise)."""
    if a2.device.type == "cpu":
        return pair_pool_backward_reference(geom, a2, b2, wg_k, w2, b2bias,
                                            m, dm, compute_dtype,
                                            elementwise_dtype)
    return launch_backward_kernel(geom, a2, b2, wg_k, w2, b2bias, m, dm,
                                  compute_dtype,
                                  elementwise_dtype=elementwise_dtype)


# K2 launches, and those of the bf16-stream instantiation among them; only
# launch_backward_kernel adds
pair_pool_backward.launches = 0
pair_pool_backward.launches_ew = 0


class PairPool2(torch.autograd.Function):
    """m = pair stage of (a', b') with K1 as forward and K2 as backward
    (port of ``_pair_pool2_p.defvjp``, ``pairwise2.py:875-896``).

    Saves its inputs and m and recomputes the pairs in the backward, as
    the TPU kernel does. The gradient reaches wg through autograd: the
    fold (:func:`fold_separable`) and the row select (:func:`_kernel_wg`)
    stay outside, as in JAX.
    """

    @staticmethod
    def forward(ctx, geom: PairGeometry, a2: Tensor, b2: Tensor,
                wg_k: Tensor, w2: Tensor, b2bias: Tensor,
                compute_dtype: str,
                elementwise_dtype: str = "float32") -> Tensor:
        if a2.device.type == "cpu":
            m = _reference_core(geom, a2, b2, wg_k, w2, b2bias, compute_dtype,
                                elementwise_dtype)
        else:
            m = launch_kernel(geom, a2, b2, wg_k, w2, b2bias, compute_dtype,
                              elementwise_dtype=elementwise_dtype)
        ctx.geom, ctx.compute_dtype = geom, compute_dtype
        ctx.elementwise_dtype = elementwise_dtype
        ctx.save_for_backward(a2, b2, wg_k, w2, b2bias, m)
        return m

    @staticmethod
    def backward(ctx, dm: Tensor):
        a2, b2, wg_k, w2, b2bias, m = ctx.saved_tensors
        grads = pair_pool_backward(ctx.geom, a2, b2, wg_k, w2, b2bias, m,
                                   dm.contiguous(), ctx.compute_dtype,
                                   ctx.elementwise_dtype)
        return (None, *grads, None, None)


def pair_pool(row_cols: Tensor, col_cols: Tensor, a: Tensor, b: Tensor,
              pair_params, neighbor_iou: float,
              classes: Tensor | None = None,
              col_classes: Tensor | None = None,
              compute_dtype: str = "bfloat16", block_sparse: bool = True,
              geometry: PairGeometry | None = None,
              elementwise_dtype: str = "float32") -> Tensor:
    """Pair stage m [B, NR, P] float32 of one block, differentiable.

    row_cols [B, 14, NR] / col_cols [B, 14, NC]: stacked DetColumns.
    a [B, NR, P] = r @ Wa + b1 (rows); b [B, NC, P] = r @ Wb (columns).
    ``geometry`` (from :func:`pair_geometry`) skips rebuilding the
    detection-only inputs; a model builds it once per forward.

    ``elementwise_dtype="bfloat16"`` (``model.pair_elementwise_dtype``,
    which needs bf16 operands) streams h1, pre2 and the running max in
    bf16, as the TPU kernel's bf16 scratch does; m stays float32.

    CPU tensors take the plain forward and backward (``block_sparse`` is
    exact, so it changes nothing there). CUDA tensors launch K1, and K2
    in the backward, or raise.
    """
    if a.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"pair_pool runs on cpu or cuda, got {a.device}")
    check_dtype(compute_dtype, elementwise_dtype)
    geom = geometry or pair_geometry(row_cols, col_cols, neighbor_iou,
                                     classes, col_classes, block_sparse)
    a2, b2 = fold_separable(pair_params.wg, a, b, geom)
    return PairPool2.apply(geom, a2.contiguous(), b2.contiguous(),
                           _kernel_wg(pair_params.wg, geom.multiclass),
                           pair_params.w2.float().contiguous(),
                           pair_params.b2.float().contiguous(), compute_dtype,
                           elementwise_dtype)


# K1 launches, and those of the bf16-stream instantiation among them; only
# launch_kernel adds to them
pair_pool.launches = 0
pair_pool.launches_ew = 0
