"""K1, the pair-pool forward: CUDA kernel wrapper, its plain version, and
the preparation both share (port of ``gossipnet_tpu/ops/pallas/pairwise2.py``).

The pair stage of a gossip block is

    m_i = max(0, max_{j in E(i)} W2^T relu(a_i + b_j + g_ij @ Wg) + b2)

over the neighbour set E(i) = {j : IoU(i, j) >= neighbor_iou, both valid}.
As on the TPU, five of the eight pair features are additively separable,
so their Wg rows fold into a and b before the kernel
(:func:`fold_separable`, O(N) torch matmuls). The kernel then computes
three features per pair (four with the class match), streams its row over
the columns with a running max, and skips whole tiles whose row and column
bounding boxes do not meet (:func:`tile_activity`; exact for
neighbor_iou > 0). Nothing of the TPU's layout (sublane packing, kron
weights, quadrant splits) carries over.

:func:`pair_pool` routes by device: CPU tensors go to
:func:`pair_pool_reference`, CUDA tensors launch the kernel
(``csrc/pairwise2_fwd.cu``) or raise.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from gossipnet_tpu_torch.ops import pair_features as pf

TILE_I, TILE_J = 32, 64   # the kernel's row / column tile (csrc constants)

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

_COMPUTE_DTYPES = ("float32", "bfloat16")
_CHUNK_ELEMENTS = 1 << 25   # pair activations per row chunk of the plain version


class PairGeometry(NamedTuple):
    """What K1 reads that depends only on the detections: built once per
    forward and shared by every block."""

    row: Tensor       # [B, CI, NR] row fields (_CI_FIELDS [+ class])
    col: Tensor       # [B, CJ, NC] column fields (_CJ_FIELDS [+ class])
    i_feats: Tensor   # [B, NR, 6] separable row-side features
    j_feats: Tensor   # [B, NC, 4] separable column-side features
    flags: Tensor     # [B, NI, NJ] int32 tile activity at TILE_I x TILE_J
    neighbor_iou: float

    @property
    def multiclass(self) -> bool:
        return self.row.shape[1] == len(_CI_FIELDS) + 1


def tile_activity(row: Tensor, col: Tensor, ti: int = TILE_I,
                  tj: int = TILE_J) -> Tensor:
    """Per tile pair flags, int32 [B, ceil(NR/ti), ceil(NC/tj)].

    A tile pair is inactive when the bounding boxes of its valid row and
    column detections do not meet: then no pair in it has IoU > 0, so
    skipping it is exact for neighbor_iou > 0 (``pairwise.py``
    ``_tile_activity``, at the CUDA kernel's tile shape; the ragged edge
    pads with invalid entries).
    """
    big = 1e30

    def extent(fields: Tensor, t: int):
        valid = fields[:, _VALID] > 0.0
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
                  block_sparse: bool = True) -> PairGeometry:
    """Kernel inputs derived from stacked DetColumns [B, 14, N] (rows and
    columns may differ, as for a row shard). ``col_classes`` defaults to
    ``classes`` (the square case)."""
    ci = pf.unstack_columns(row_cols.float())
    cj = pf.unstack_columns(col_cols.float())
    row = [ci.x1, ci.y1, ci.x2, ci.y2, ci.area, 1.0 / ci.w, 1.0 / ci.h,
           ci.valid]
    col = [cj.x1, cj.y1, cj.x2, cj.y2, cj.area, cj.cx, cj.cy, cj.valid]
    if classes is not None:
        col_classes = classes if col_classes is None else col_classes
        row.append(classes.float())
        col.append(col_classes.float())
    row_t = torch.stack(row, dim=1).contiguous()
    col_t = torch.stack(col, dim=1).contiguous()
    i_feats = torch.stack([-ci.cx / ci.w, -ci.cy / ci.h, -ci.log_w,
                           -ci.log_h, -ci.log_aspect, ci.score], dim=-1)
    j_feats = torch.stack([cj.log_w, cj.log_h, cj.log_aspect, cj.score],
                          dim=-1)
    if block_sparse and neighbor_iou > 0.0:
        flags = tile_activity(row_t, col_t)
    else:
        b, nr, nc = row_t.shape[0], row_t.shape[2], col_t.shape[2]
        flags = torch.ones((b, -(-nr // TILE_I), -(-nc // TILE_J)),
                           dtype=torch.int32, device=row_t.device)
    return PairGeometry(row_t, col_t, i_feats, j_feats, flags.contiguous(),
                        float(neighbor_iou))


def fold_separable(wg: Tensor, a: Tensor, b: Tensor,
                   geom: PairGeometry) -> tuple[Tensor, Tensor]:
    """a' = a + i_feats @ wg[_SEP_I], b' = b + j_feats @ wg[_SEP_J], in f32."""
    wg = wg.float()
    a2 = a.float() + geom.i_feats @ wg[list(_SEP_I)]
    b2 = b.float() + geom.j_feats @ wg[list(_SEP_J)]
    return a2, b2


def _kernel_wg(wg: Tensor, multiclass: bool) -> Tensor:
    rows = _KERNEL_ROWS_MC if multiclass else _KERNEL_ROWS
    return wg.float()[list(rows)].contiguous()


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")


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


def _reference_core(geom: PairGeometry, a2: Tensor, b2: Tensor, wg_k: Tensor,
                    w2: Tensor, b2bias: Tensor,
                    compute_dtype: str) -> Tensor:
    """The kernel's arithmetic in torch, in row chunks of at most
    ``_CHUNK_ELEMENTS`` pair activations, rounding in bf16 mode where the
    kernel rounds (so the two differ only by summation order)."""
    bf16 = compute_dtype == "bfloat16"

    def rnd(x: Tensor) -> Tensor:
        return x.to(torch.bfloat16).float() if bf16 else x

    row, col = geom.row, geom.col
    bsz, _, nr = row.shape
    nc = col.shape[2]
    p = a2.shape[-1]
    wk, w2r = rnd(wg_k.float()), rnd(w2.float())
    bj = rnd(b2)[:, None, :, :]                          # [B, 1, NC, P]
    thr = torch.tensor(geom.neighbor_iou, dtype=torch.float32,
                       device=row.device)
    cj = col[:, :, None, :]                              # [B, CJ, 1, NC]
    out = torch.empty((bsz, nr, p), dtype=torch.float32, device=row.device)
    chunk = max(1, _CHUNK_ELEMENTS // max(bsz * nc * p, 1))
    for r0 in range(0, nr, chunk):
        ri = row[:, :, r0:r0 + chunk, None]              # [B, CI, rc, 1]
        iou = fields_iou(ri, cj)
        nb = (iou >= thr) & (ri[:, _VALID] > 0.0) & (cj[:, _VALID] > 0.0)
        feats = [iou, cj[:, 5] * ri[:, 5], cj[:, 6] * ri[:, 6]]
        if geom.multiclass:
            feats.append((ri[:, 8] == cj[:, 8]).float())
        g = rnd(torch.stack(feats, dim=-1))              # [B, rc, NC, K]
        h1 = torch.relu(a2[:, r0:r0 + chunk, None, :] + (g @ wk + bj))
        pre2 = rnd(h1) @ w2r + b2bias.float()            # [B, rc, NC, P]
        pre2 = torch.where(nb[..., None], pre2, torch.zeros_like(pre2))
        out[:, r0:r0 + chunk] = torch.clamp(pre2.amax(dim=2), min=0.0)
    return out


def pair_pool_reference(row_cols: Tensor, col_cols: Tensor, a: Tensor,
                        b: Tensor, pair_params, neighbor_iou: float,
                        classes: Tensor | None = None,
                        col_classes: Tensor | None = None,
                        compute_dtype: str = "bfloat16",
                        geometry: PairGeometry | None = None) -> Tensor:
    """Plain PyTorch K1 on any device -> m [B, NR, P] float32.

    Same arguments as :func:`pair_pool`; ``pair_params`` has ``wg``
    [G, P], ``w2`` [P, P] (in, out) and ``b2`` [P]. The CPU path of
    :func:`pair_pool` and the kernel's oracle on the card.
    """
    _check_dtype(compute_dtype)
    geom = geometry or pair_geometry(row_cols, col_cols, neighbor_iou,
                                     classes, col_classes)
    a2, b2 = fold_separable(pair_params.wg, a, b, geom)
    return _reference_core(geom, a2, b2, _kernel_wg(pair_params.wg,
                                                    geom.multiclass),
                           pair_params.w2, pair_params.b2, compute_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from gossipnet_tpu_torch.ops.cuda import build

    lib = build.load("pairwise2_fwd")
    if not getattr(lib, "_gnet_bound", False):
        lib.gnet_pair_pool2_tiles.argtypes = []
        lib.gnet_pair_pool2_tiles.restype = ctypes.c_int
        lib.gnet_pair_pool2_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.gnet_pair_pool2_fwd.restype = ctypes.c_int
        tiles = lib.gnet_pair_pool2_tiles()
        if tiles != TILE_I * 1000 + TILE_J:
            raise RuntimeError(f"pairwise2_fwd.cu tiles {tiles} do not match "
                               f"TILE_I={TILE_I}, TILE_J={TILE_J}")
        lib._gnet_bound = True
    return lib


def launch_kernel(geom: PairGeometry, a2: Tensor, b2: Tensor, wg_k: Tensor,
                  w2: Tensor, b2bias: Tensor, compute_dtype: str) -> Tensor:
    """One K1 launch on the current stream -> m [B, NR, P] float32.

    Checks device, dtype, shape and contiguity and raises on anything the
    kernel does not take; raises if the launch is refused.
    """
    _check_dtype(compute_dtype)
    bsz, ci, nr = geom.row.shape
    nc = geom.col.shape[2]
    p = a2.shape[-1]
    k = wg_k.shape[0]
    expect = {
        "row": (geom.row, (bsz, ci, nr), torch.float32),
        "col": (geom.col, (bsz, ci, nc), torch.float32),
        "a'": (a2, (bsz, nr, p), torch.float32),
        "b'": (b2, (bsz, nc, p), torch.float32),
        "wg_k": (wg_k, (k, p), torch.float32),
        "w2": (w2, (p, p), torch.float32),
        "b2": (b2bias, (p,), torch.float32),
        "flags": (geom.flags, (bsz, -(-nr // TILE_I), -(-nc // TILE_J)),
                  torch.int32),
    }
    device = a2.device
    if device.type != "cuda":
        raise RuntimeError(f"K1 kernel needs CUDA tensors, got {device}")
    for name, (t, shape, dtype) in expect.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p not in (8, 16, 32, 64):
        raise ValueError(f"K1 is built for pairwise_dim 8/16/32/64, got {p}")
    if (k, ci) not in ((3, 8), (4, 9)):
        raise ValueError(f"K1 takes 3 features with 8 fields or 4 with 9, "
                         f"got {k} and {ci}")
    lib = _library()
    out = torch.empty((bsz, nr, p), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gnet_pair_pool2_fwd(
            geom.row.data_ptr(), geom.col.data_ptr(), a2.data_ptr(),
            b2.data_ptr(), wg_k.data_ptr(), w2.data_ptr(),
            b2bias.data_ptr(), geom.flags.data_ptr(), out.data_ptr(),
            bsz, nr, nc, p, k, geom.neighbor_iou,
            int(compute_dtype == "bfloat16"), stream)
    if err != 0:
        raise RuntimeError(f"K1 (pairwise2_fwd.cu) launch failed: CUDA "
                           f"error {err}")
    pair_pool.launches += 1
    return out


def pair_pool(row_cols: Tensor, col_cols: Tensor, a: Tensor, b: Tensor,
              pair_params, neighbor_iou: float,
              classes: Tensor | None = None,
              col_classes: Tensor | None = None,
              compute_dtype: str = "bfloat16", block_sparse: bool = True,
              geometry: PairGeometry | None = None) -> Tensor:
    """Pair stage m [B, NR, P] float32 of one block.

    row_cols [B, 14, NR] / col_cols [B, 14, NC]: stacked DetColumns.
    a [B, NR, P] = r @ Wa + b1 (rows); b [B, NC, P] = r @ Wb (columns).
    ``geometry`` (from :func:`pair_geometry`) skips rebuilding the
    detection-only inputs; a model builds it once per forward.

    CPU tensors take the plain version (``block_sparse`` is exact, so it
    changes nothing there). CUDA tensors launch K1 or raise. K1 has no
    backward yet (K2): on CUDA with autograd recording, this raises.
    """
    if a.device.type == "cpu":
        return pair_pool_reference(row_cols, col_cols, a, b, pair_params,
                                   neighbor_iou, classes, col_classes,
                                   compute_dtype, geometry)
    if a.device.type != "cuda":
        raise RuntimeError(f"pair_pool runs on cpu or cuda, got {a.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, b, pair_params.wg, pair_params.w2,
                                      pair_params.b2)):
        raise RuntimeError(
            "pair_pool on CUDA has no backward yet: the pair-pool backward "
            "kernel (K2, ROADMAP.md) is not ported; run under "
            "torch.inference_mode() or torch.no_grad()")
    _check_dtype(compute_dtype)
    geom = geometry or pair_geometry(row_cols, col_cols, neighbor_iou,
                                     classes, col_classes, block_sparse)
    a2, b2 = fold_separable(pair_params.wg, a, b, geom)
    return launch_kernel(geom, a2.contiguous(), b2.contiguous(),
                         _kernel_wg(pair_params.wg, geom.multiclass),
                         pair_params.w2.float().contiguous(),
                         pair_params.b2.float().contiguous(), compute_dtype)


pair_pool.launches = 0   # K1 launches; only launch_kernel adds to it
