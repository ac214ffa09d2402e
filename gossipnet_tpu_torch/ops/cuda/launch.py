"""The launch plumbing the pair kernels share: K1/K2 (``pairwise2.py``)
and K5/K6 (``pairwise.py``) take the same argument list, so one input
check, one ctypes binding and one partial-sum step serve all four.

A pair kernel's C entry takes the pointers of its tensors, six ints
(B, NR, NC, P, the features K or G, the splits S of :func:`col_splits`),
the neighbour threshold, a mode word (:func:`kernel_mode`) and the CUDA
stream, and returns a
CUDA error code. Its ``*_tiles`` function reports the tile shape it was
built with, checked against :data:`TILE_I` x :data:`TILE_J` once per
library.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

TILE_I, TILE_J = 32, 64   # the kernels' row / column tile (csrc constants)
MAX_DETS = 1 << 15        # an entry packs (row << 16) | column (pair_group.cuh)
COMPUTE_DTYPES = ("float32", "bfloat16")


def check_dtype(compute_dtype: str,
                elementwise_dtype: str = "float32") -> None:
    """The operand dtype of the pair products and the dtype of the
    streamed pair tensors (``pairwise2.py:933-937`` of the JAX package)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if elementwise_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"elementwise_dtype must be one of "
                         f"{COMPUTE_DTYPES}, got {elementwise_dtype!r}")
    if elementwise_dtype == "bfloat16" and compute_dtype != "bfloat16":
        raise ValueError(
            "elementwise_dtype=bfloat16 requires compute_dtype=bfloat16 "
            "(config.validate_config enforces the same)")


def kernel_mode(compute_dtype: str, elementwise_dtype: str = "float32") -> int:
    """The mode word a pair kernel's C entry takes: 0 f32, 1 bf16 operands,
    2 bf16 operands and a bf16 stream (K1/K2 only)."""
    check_dtype(compute_dtype, elementwise_dtype)
    return (int(compute_dtype == "bfloat16")
            + int(elementwise_dtype == "bfloat16"))


def _library(name: str, entry: str, tiles: str, n_ptr: int) -> ctypes.CDLL:
    """Kernel library ``name`` with its launch function ``entry`` bound
    (``n_ptr`` pointers, six ints, the threshold, the mode word, the
    stream) and the tile shape its ``tiles`` function reports checked."""
    from gossipnet_tpu_torch.ops.cuda import build

    lib = build.load(name)
    if not getattr(lib, "_gnet_bound", False):
        fn, tiles_fn = getattr(lib, entry), getattr(lib, tiles)
        tiles_fn.argtypes = []
        tiles_fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        got = tiles_fn()
        if got != TILE_I * 1000 + TILE_J:
            raise RuntimeError(f"{name}.cu tiles {got} do not match "
                               f"TILE_I={TILE_I}, TILE_J={TILE_J}")
        lib._gnet_bound = True
    return lib


def check_inputs(label: str, geom, a: Tensor, b: Tensor, wg: Tensor,
                 w2: Tensor, b2bias: Tensor, compute_dtype: str,
                 layouts: tuple, elementwise_dtype: str = "float32",
                 **rows_p: Tensor) -> None:
    """Device, dtype, shape and contiguity of a pair-kernel launch; raises
    on anything the kernel does not take, a bf16 stream with f32 operands
    first. ``geom`` has ``row`` [B, C, NR], ``col`` [B, C, NC] and
    ``flags``; ``layouts``: the (rows of wg, C) pairs the kernel takes;
    ``rows_p``: further [B, NR, P] float32 inputs (the backward's m and
    dm)."""
    check_dtype(compute_dtype, elementwise_dtype)
    bsz, c, nr = geom.row.shape
    nc = geom.col.shape[2]
    p = a.shape[-1]
    k = wg.shape[0]
    expect = {
        "row": (geom.row, (bsz, c, nr), torch.float32),
        "col": (geom.col, (bsz, c, nc), torch.float32),
        "a": (a, (bsz, nr, p), torch.float32),
        "b": (b, (bsz, nc, p), torch.float32),
        "wg": (wg, (k, p), torch.float32),
        "w2": (w2, (p, p), torch.float32),
        "b2": (b2bias, (p,), torch.float32),
        "flags": (geom.flags, (bsz, -(-nr // TILE_I), -(-nc // TILE_J)),
                  torch.int32),
    }
    expect.update({n: (t, (bsz, nr, p), torch.float32)
                   for n, t in rows_p.items()})
    device = a.device
    if device.type != "cuda":
        raise RuntimeError(f"{label} kernel needs CUDA tensors, got {device}")
    for n, (t, shape, dtype) in expect.items():
        if t.device != device:
            raise ValueError(f"{n} is on {t.device}, expected {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{n}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if p not in (8, 16, 32, 64):
        raise ValueError(f"{label} is built for pairwise_dim 8/16/32/64, "
                         f"got {p}")
    if (k, c) not in layouts:
        raise ValueError(f"{label} takes (features, detection fields) in "
                         f"{layouts}, got ({k}, {c})")


def _launch(name: str, label: str, entry: str, tiles: str, geom,
            tensors: tuple, p: int, k: int, splits: int, mode: int) -> None:
    """One launch of ``entry`` of library ``name`` on the current stream
    with the pointers of ``tensors``, the sizes (B, NR, NC, P, K), the
    splits, geom's threshold and the mode word (:func:`kernel_mode`);
    raises if the launch is refused."""
    lib = _library(name, entry, tiles, len(tensors))
    bsz, _, nr = geom.row.shape
    device = geom.row.device

    def call():
        return getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), bsz, nr, geom.col.shape[2], p,
            k, splits, geom.neighbor_iou, mode,
            torch.cuda.current_stream().cuda_stream)

    if torch.cuda.current_device() == device.index:
        err = call()          # the usual case: no device switch to pay for
    else:
        with torch.cuda.device(device):
            err = call()
    if err != 0:
        raise RuntimeError(f"{label} ({name}.cu) launch failed: CUDA error "
                           f"{err}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def col_splits(blocks: int, nj: int, sms: int) -> int:
    """How many blocks share the work on one tile of 32 own detections in
    a pair kernel: enough that ``blocks`` (tiles x images) times the splits
    give every one of the card's ``sms`` multiprocessors about eight
    blocks, and at most one split per step of two tests (a tile of the
    other side, of which there are ``nj``, is eight steps to a warp). The
    splits take the steps round robin, so a crowded tile is spread over
    all of them. The forwards (K1, K5) merge their maxima with an
    order-free integer max; the backwards (K2, K6) sum into slices of
    their own that their last step adds in order."""
    want = -(-8 * sms // max(blocks, 1))
    return max(1, min(want, 8 * nj))


def _splits(geom, device, whole_matrix: bool = False) -> int:
    """:func:`col_splits` for a launch, its blocks counted over its own
    row tiles, or with ``whole_matrix`` over those of the whole pair
    matrix, max(NR, NC) rows. The backwards (K2, K6) take the whole
    matrix's: a row shard of the det-sharded forward (NR = N / n_det
    against NC = N) then splits as the square launch does, so it adds each
    row's partial d_a in the same order, and the shards' d_a joined equals
    the square launch's bit for bit. The forwards (K1, K5) keep their own:
    their max is order-free, and a shard's fewer row tiles want more
    splits to fill the card."""
    nb, ni, nj = geom.flags.shape
    if whole_matrix:
        ni = -(-max(geom.row.shape[2], geom.col.shape[2]) // TILE_I)
    return col_splits(nb * ni, nj, _sm_count(device.index or 0))


def forward_launch(name: str, label: str, entry: str, tiles: str, geom,
                   a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
                   b2bias: Tensor, compute_dtype: str,
                   elementwise_dtype: str = "float32") -> Tensor:
    """A pair-pool forward kernel (K1 or K5) -> m [B, NR, P] float32;
    inputs already checked. Where the kernel splits a row tile over
    several blocks (:func:`col_splits`), its entry zero-fills the output
    the splits merge into."""
    p = a.shape[-1]
    out = torch.empty((a.shape[0], a.shape[1], p), dtype=torch.float32,
                      device=a.device)
    _launch(name, label, entry, tiles, geom,
            (geom.row, geom.col, a, b, wg, w2, b2bias, geom.flags, out),
            p, wg.shape[0], _splits(geom, a.device),
            kernel_mode(compute_dtype, elementwise_dtype))
    return out


def backward_launch(name: str, label: str, entry: str, tiles: str, geom,
                    a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
                    b2bias: Tensor, m: Tensor, dm: Tensor,
                    compute_dtype: str, elementwise_dtype: str = "float32"):
    """A pair-pool backward kernel (K2 or K6) -> (d_a, d_b, dWg, dW2,
    db2) float32; inputs already checked.

    Every gradient is summed from partial sums in a fixed order (no float
    atomics), in the kernel or here, so two launches on the same inputs
    give identical bits. The kernel takes the number of splits S
    (:func:`col_splits`) and two scratch tensors [S, B, NR, P] and
    [S, B, NC, P], one slice per split, which it adds in order into d_a
    and d_b itself; its weight gradients leave per block and split and are
    summed here.
    """
    bsz, nr, p = a.shape
    nc, k, ni = b.shape[1], wg.shape[0], geom.flags.shape[1]
    f32 = dict(dtype=torch.float32, device=a.device)
    s = _splits(geom, a.device, whole_matrix=True)
    da = torch.empty((bsz, nr, p), **f32)
    db = torch.empty((bsz, nc, p), **f32)
    # scratch: one slice per split, added in order by the kernel's last
    # step (not touched when there is one split)
    scratch = (torch.empty((s if s > 1 else 0, bsz, nr, p), **f32),
               torch.empty((s if s > 1 else 0, bsz, nc, p), **f32))
    dwg_part = torch.empty((s * bsz * ni, k, p), **f32)
    dw2_part = torch.empty((s * bsz * ni, p, p), **f32)
    db2_part = torch.empty((s * bsz * ni, p), **f32)
    _launch(name, label, entry, tiles, geom,
            (geom.row, geom.col, a, b, wg, w2, b2bias, geom.flags, m, dm, da,
             db, *scratch, dwg_part, dw2_part, db2_part), p, k, s,
            kernel_mode(compute_dtype, elementwise_dtype))
    return (da, db, dwg_part.sum(dim=0), dw2_part.sum(dim=0),
            db2_part.sum(dim=0))


def check_packable(label: str, geom) -> None:
    """The pair kernels name a queued pair by (row << 16) | column."""
    nr, nc = geom.row.shape[2], geom.col.shape[2]
    if max(nr, nc) > MAX_DETS:
        raise ValueError(f"{label} takes at most {MAX_DETS} detections per "
                         f"image, got NR={nr}, NC={nc}")
