"""The launch plumbing the pair kernels share: K1/K2 (``pairwise2.py``)
and K5/K6 (``pairwise.py``) take the same argument list, so one input
check, one ctypes binding and one partial-sum step serve all four.

A pair kernel's C entry takes the pointers of its tensors, six ints
(B, NR, NC, P, the features K or G, the splits S of :func:`col_splits`),
the neighbour threshold, a mode word (:func:`kernel_mode`), the skip tile
(FI, TJ) of the geometry's flags and the CUDA stream, and returns a CUDA
error code. Its ``*_tiles(fi, tj)`` function says whether the library
takes a tile; each library is checked once to take exactly :data:`TILES`.

The skip tile is the FI rows x TJ columns of the pair matrix that one flag
of ``pairwise2.tile_activity`` covers. A block still owns
:data:`BLOCK_ROWS` detections, one per lane; the tile sets which flag row
those rows read and the column step of stage A. Every tile of
:data:`TILES` gives the same m (an order-free max); the backwards' sums
follow the stage loop's order, which TJ sets.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

BLOCK_ROWS = 32            # detections a block owns, one per lane (csrc TILE_I)
# the skip tiles (FI, TJ) the kernels take, and the one a model uses unless
# told otherwise (GossipNet(pair_tile=...))
TILES = tuple((fi, tj) for fi in (32, 64) for tj in (16, 32, 64, 128))
DEFAULT_TILE = (32, 64)
TILE_I, TILE_J = DEFAULT_TILE
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


def check_tile(tile) -> tuple[int, int]:
    """``tile`` as an (FI, TJ) of :data:`TILES`; ``None`` is
    :data:`DEFAULT_TILE`. Raises on any other shape: nothing is rounded to
    a tile the kernels take."""
    if tile is None:
        return DEFAULT_TILE
    got = tuple(int(t) for t in tile)
    if got not in TILES:
        raise ValueError(f"pair tile {tuple(tile)} is not one the pair "
                         f"kernels take: (FI, TJ) in {TILES}")
    return got


def kernel_mode(compute_dtype: str, elementwise_dtype: str = "float32") -> int:
    """The mode word a pair kernel's C entry takes: 0 f32, 1 bf16 operands,
    2 bf16 operands and a bf16 stream (K1/K2 only)."""
    check_dtype(compute_dtype, elementwise_dtype)
    return (int(compute_dtype == "bfloat16")
            + int(elementwise_dtype == "bfloat16"))


def _library(name: str, entry: str, tiles: str, n_ptr: int) -> ctypes.CDLL:
    """Kernel library ``name`` with its launch function ``entry`` bound
    (``n_ptr`` pointers, six ints, the threshold, the mode word, FI and
    TJ, the stream), checked once to take every tile of :data:`TILES`
    and no other power-of-two shape from 8 to 256."""
    from gossipnet_tpu_torch.ops.cuda import build

    lib = build.load(name)
    if not getattr(lib, "_gnet_bound", False):
        fn, tiles_fn = getattr(lib, entry), getattr(lib, tiles)
        tiles_fn.argtypes = [ctypes.c_int, ctypes.c_int]
        tiles_fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        sizes = [1 << s for s in range(3, 9)]
        got = tuple((fi, tj) for fi in sizes for tj in sizes
                    if tiles_fn(fi, tj) == 1)
        if got != TILES:
            raise RuntimeError(f"{name}.cu takes the tiles {got}, the "
                               f"wrapper expects {TILES}")
        lib._gnet_bound = True
    return lib


def check_inputs(label: str, geom, a: Tensor, b: Tensor, wg: Tensor,
                 w2: Tensor, b2bias: Tensor, compute_dtype: str,
                 layouts: tuple, elementwise_dtype: str = "float32",
                 **rows_p: Tensor) -> None:
    """Device, dtype, shape and contiguity of a pair-kernel launch; raises
    on anything the kernel does not take, a bf16 stream with f32 operands
    first. ``geom`` has ``row`` [B, C, NR], ``col`` [B, C, NC] and
    ``flags`` at ``geom.tile``; ``layouts``: the (rows of wg, C) pairs the
    kernel takes; ``rows_p``: further [B, NR, P] float32 inputs (the
    backward's m and dm)."""
    check_dtype(compute_dtype, elementwise_dtype)
    fi, tj = check_tile(geom.tile)
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
        "flags": (geom.flags, (bsz, -(-nr // fi), -(-nc // tj)),
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
    splits, geom's threshold, the mode word (:func:`kernel_mode`) and
    geom's skip tile; raises if the launch is refused."""
    lib = _library(name, entry, tiles, len(tensors))
    fi, tj = check_tile(geom.tile)
    bsz, _, nr = geom.row.shape
    device = geom.row.device

    def call():
        return getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), bsz, nr, geom.col.shape[2], p,
            k, splits, geom.neighbor_iou, mode, fi, tj,
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


def col_splits(blocks: int, nj: int, sms: int, tj: int = TILE_J) -> int:
    """How many blocks share the work on one tile of 32 own detections in
    a pair kernel: enough that ``blocks`` (tiles x images) times the splits
    give every one of the card's ``sms`` multiprocessors about eight
    blocks, and at most one split per step of two tests (a tile of ``tj``
    detections of the other side, of which there are ``nj``, is tj / 8
    steps to a warp). The splits take the steps round robin, so a crowded
    tile is spread over all of them. The forwards (K1, K5) merge their
    maxima with an order-free integer max; the backwards (K2, K6) sum into
    slices of their own that their last step adds in order."""
    want = -(-8 * sms // max(blocks, 1))
    return max(1, min(want, nj * tj // 8))


def _splits(geom, device, whole_matrix: bool = False) -> int:
    """:func:`col_splits` for a launch, its blocks counted over its own
    rows, :data:`BLOCK_ROWS` to a block whatever the skip tile, or with
    ``whole_matrix`` over those of the whole pair matrix, max(NR, NC)
    rows; the steps over the flags' NJ tiles of TJ. The backwards (K2, K6)
    take the whole matrix's: a row shard of the det-sharded forward (NR = N / n_det
    against NC = N) then splits as the square launch does, so it adds each
    row's partial d_a in the same order, and the shards' d_a joined equals
    the square launch's bit for bit. The forwards (K1, K5) keep their own:
    their max is order-free, and a shard's fewer row tiles want more
    splits to fill the card."""
    nb, _, nj = geom.flags.shape
    rows = geom.row.shape[2]
    if whole_matrix:
        rows = max(rows, geom.col.shape[2])
    return col_splits(nb * -(-rows // BLOCK_ROWS), nj,
                      _sm_count(device.index or 0),
                      check_tile(geom.tile)[1])


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
    and d_b itself; its weight gradients leave per block (of
    :data:`BLOCK_ROWS` rows) and split and are summed here.
    """
    bsz, nr, p = a.shape
    nc, k, ni = b.shape[1], wg.shape[0], -(-nr // BLOCK_ROWS)
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
