"""K7, the per-tile ablation of the unfolded pair tile: CUDA kernel wrapper
and plain version (port of the kernel of ``scripts/kernel_ablate.py``).

A measuring probe, not a model path: K5's pair tile (``pairwise.py``) at
P = 32, G = 8 with bf16 dots, dense (no tile skip, no separable fold), with
one stage switched off per mode, so the difference of two modes' times is
what a stage costs on the card. The kernel computes every pair through
every stage its mode keeps and applies the mask last, as a select, so two
modes differ by the switched-off stage and by nothing else:

    out[b, i, :] = max_j (neighbour(i, j) ? h2(i, j) : -1e30)
    h2 = relu(W2^T relu((a_i + b_j) + Wg^T g_ij) + b2)

========  ==============================================================
full      as above
nofeat    IoU stand-in ``(x1_i + x1_j) * 0.001``, every feature that
          value; the mask runs on the stand-in
nogw      ``Wg^T g`` replaced by zeros
nofc2     ``h2 = h1``
nomask    no mask: the max runs over every column
bf3d      bf16 elementwise: ``(bf16(a) + bf16(b)) + bf16(gw)`` with each
          add rounded, ``bf16(dot) + bf16(b2)``, -1e30 as bf16
========  ==============================================================

A row without a neighbour gives -1e30 (as bf16 in ``bf3d``), not 0.
Layouts are K5's: ``cols`` [B, 14, N] stacked DetColumns, ``a``/``b``
[B, N, P], ``wg`` [G, P], ``w2`` [P, P] (in, out), ``b2`` [P]; the result
is [B, N, P], so it can feed ``a`` of the next call as the probe chains it.

:func:`pair_ablate` routes by device: CUDA tensors launch the kernel
(``csrc/pair_ablate.cu``) or raise, CPU tensors run
:func:`pair_ablate_reference`, which repeats the kernel's arithmetic (its
fmaf chains in float64, ``pairwise2._fma``; the same bf16 rounding points).
The kernel runs FC2 on the tensor cores (``pair_group.cuh::fc2_mma``), so
its sum of the same exact bf16 products is in another order than the
plain version's fmaf chain: rtol = atol = 1e-5 in the five f32 modes, one
bf16 step in ``bf3d``; h1 and everything before it are the plain
version's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda.launch import TILE_I
from gossipnet_tpu_torch.ops.cuda.pairwise2 import _fma

MODES = ("full", "nofeat", "nogw", "nofc2", "nomask", "bf3d")
TILE_JS = (32, 64, 128)   # column tiles the kernel is instantiated for
P, G = 32, pf.NUM_PAIR_FEATURES
NEG = -1e30
_CHUNK_ELEMENTS = 1 << 25   # pair activations per row chunk of the plain version


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).float()


def _check(cols: Tensor, a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
           b2: Tensor, mode: str, tile_j: int) -> None:
    """Mode, tile, shapes, dtypes, devices and contiguity; raises on
    anything the kernel does not take (the plain version takes the same)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if tile_j not in TILE_JS:
        raise ValueError(f"tile_j must be one of {TILE_JS} (the column "
                         f"tiles the kernel is built for), got {tile_j!r}")
    bsz, n = cols.shape[0], cols.shape[-1]
    expect = {"cols": (cols, (bsz, pf.NUM_COLUMNS, n)),
              "a": (a, (bsz, n, P)), "b": (b, (bsz, n, P)),
              "wg": (wg, (G, P)), "w2": (w2, (P, P)), "b2": (b2, (P,))}
    for name, (t, shape) in expect.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} torch.float32 (K7 is built "
                             f"for P={P}, G={G})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _fc2_fmaf(h1: Tensor, w2r: Tensor) -> Tensor:
    """FC2's dot as an fmaf chain from 0 over the input index p ascending."""
    pre2 = torch.zeros_like(h1)
    for p in range(P):
        pre2 = _fma(h1[..., p:p + 1], w2r[p], pre2)
    return pre2


def _fc2_mma(h1: Tensor, w2r: Tensor) -> Tensor:
    """FC2's dot in the order of the kernel's tensor-core product
    (``fc2_mma``, two m16n8k16 k blocks): from 0, each block of 16 exact
    bf16 x bf16 products summed exactly (float64) and added to the f32
    accumulator with one rounding. The hardware adds a block with its own
    alignment and rounding, so this is the order, not the card's bits."""
    acc = torch.zeros(h1.shape, dtype=torch.float64, device=h1.device)
    h, w = h1.double(), w2r.double()
    for k0 in range(0, P, 16):
        acc = (acc + h[..., k0:k0 + 16] @ w[k0:k0 + 16]).float().double()
    return acc.float()


_FC2_ORDERS = {"fmaf": _fc2_fmaf, "mma": _fc2_mma}


def pair_ablate_reference(cols: Tensor, a: Tensor, b: Tensor, wg: Tensor,
                          w2: Tensor, b2: Tensor, mode: str,
                          tile_j: int = 64, thr: float = 0.2,
                          fc2_order: str = "fmaf") -> Tensor:
    """Plain PyTorch K7 on any device -> [B, N, P] float32: the dense
    [B, rows, N, P] pair tensor in row chunks, with the kernel's rounding
    points (explicit bf16 casts on the dots' operands, bf16 adds in
    ``bf3d``) and its fmaf chains. ``tile_j`` changes nothing here.
    ``fc2_order``: ``"fmaf"`` (the oracle) sums FC2 as an fmaf chain,
    ``"mma"`` in the tensor cores' order (``_fc2_mma``; the tests use it
    to show that the oracle's tolerance holds that order)."""
    _check(cols, a, b, wg, w2, b2, mode, tile_j)
    fc2 = _FC2_ORDERS[fc2_order]
    bf = mode == "bf3d"
    bsz, _, n = cols.shape
    f32 = dict(dtype=torch.float32, device=a.device)
    wgr, w2r = _bf16(wg), _bf16(w2)
    if bf:
        a, b, b2 = _bf16(a), _bf16(b), _bf16(b2)
    neg = torch.tensor(NEG, **f32)
    neg = _bf16(neg) if bf else neg
    thr_t = torch.tensor(thr, **f32)
    milli = torch.tensor(0.001, **f32)
    cj = pf.DetColumns(*cols[:, :, None, :].unbind(1))           # [B, 1, N]
    out = torch.empty((bsz, n, P), **f32)
    chunk = max(1, _CHUNK_ELEMENTS // max(bsz * n * P, 1))
    for r0 in range(0, n, chunk):
        rows = slice(r0, min(r0 + chunk, n))
        ci = pf.DetColumns(*cols[:, :, rows, None].unbind(1))    # [B, rc, 1]
        if mode == "nofeat":
            iou = (ci.x1 + cj.x1) * milli
            feats = [iou] * G
        else:
            iou = pf.pair_iou(ci, cj)
            feats = pf.pair_feature_list(ci, cj, iou=iou)
        ab = a[:, rows, None, :] + b[:, None, :, :]              # [B, rc, N, P]
        gw = torch.zeros_like(ab)
        if mode != "nogw":
            g = _bf16(torch.stack(feats, dim=-1))                # [B, rc, N, G]
            for k in range(G):
                gw = _fma(g[..., k:k + 1], wgr[k], gw)
        u1 = _bf16(_bf16(ab) + _bf16(gw)) if bf else ab + gw
        h1 = torch.clamp(u1, min=0.0)
        if mode == "nofc2":
            h2 = h1
        else:
            h1 = h1 if bf else _bf16(h1)                         # the dot's operand
            pre2 = fc2(h1, w2r)
            pre2 = _bf16(_bf16(pre2) + b2) if bf else pre2 + b2
            h2 = torch.clamp(pre2, min=0.0)
        if mode != "nomask":
            nb = (iou >= thr_t) & (ci.valid > 0.0) & (cj.valid > 0.0)
            h2 = torch.where(nb[..., None], h2, neg)
        out[:, rows] = h2.amax(dim=2)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from gossipnet_tpu_torch.ops.cuda import build

    lib = build.load("pair_ablate")
    if not getattr(lib, "_gnet_bound", False):
        lib.gnet_pair_ablate_shape.argtypes = []
        lib.gnet_pair_ablate_shape.restype = ctypes.c_int
        lib.gnet_pair_ablate.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.gnet_pair_ablate.restype = ctypes.c_int
        got = lib.gnet_pair_ablate_shape()
        want = TILE_I * 1000000 + P * 1000 + len(MODES)
        if got != want:
            raise RuntimeError(f"pair_ablate.cu was built for {got}, the "
                               f"wrapper expects {want} (TILE_I, P, modes)")
        lib._gnet_bound = True
    return lib


def launch_kernel(cols: Tensor, a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
                  b2: Tensor, mode: str, tile_j: int = 64,
                  thr: float = 0.2) -> Tensor:
    """One K7 launch on the current stream -> [B, N, P] float32. Raises on
    inputs the kernel does not take and if the launch is refused."""
    _check(cols, a, b, wg, w2, b2, mode, tile_j)
    if a.device.type != "cuda":
        raise RuntimeError(f"K7 kernel needs CUDA tensors, got {a.device}")
    lib = _library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.gnet_pair_ablate(
            cols.data_ptr(), a.data_ptr(), b.data_ptr(), wg.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), a.shape[0],
            a.shape[1], MODES.index(mode), tile_j, thr,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 (pair_ablate.cu) launch failed: CUDA error "
                           f"{err}")
    pair_ablate.launches += 1
    return out


def pair_ablate(cols: Tensor, a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
                b2: Tensor, mode: str, tile_j: int = 64,
                thr: float = 0.2) -> Tensor:
    """The ablated pair tile of ``mode`` -> [B, N, P] float32: K7 on CUDA
    tensors (or raise), the plain version on CPU tensors."""
    if a.device.type == "cpu":
        return pair_ablate_reference(cols, a, b, wg, w2, b2, mode, tile_j,
                                     thr)
    return launch_kernel(cols, a, b, wg, w2, b2, mode, tile_j, thr)


pair_ablate.launches = 0   # K7 launches; only launch_kernel adds to it


def tile_count(bsz: int, n: int, tile_j: int) -> int:
    """Tiles one launch walks: B * ceil(N / 32) * ceil(N / tile_j)."""
    return bsz * -(-n // TILE_I) * -(-n // tile_j)
