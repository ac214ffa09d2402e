"""K3 and K4, the greedy matching scan: CUDA kernel wrappers and their plain
version (port of ``gossipnet_tpu/ops/pallas/matching_kernel.py``).

The scan walks score-sorted detections in order; each takes, among the GTs
not yet taken at its threshold, the one of largest IoU with IoU >= t, the
lowest index winning ties. The IoU arrives pre-masked (invalid detections
and non-real GTs zeroed), so thresholds must be > 0.

:func:`greedy_scan_batched` (K3, [B, N, G]) and :func:`greedy_scan` (K4,
[N, G]) launch ``csrc/matching_scan.cu`` on CUDA tensors, or raise; on CPU
tensors they run :func:`greedy_scan_reference`. Thresholds are a 1-D
float tensor, on the host or on the IoU's device, or a
:class:`Thresholds` pair, whose device copy a captured step reads without
a copy. The kernel does comparisons only, so it equals the plain version
exactly.

:func:`scan_lists_reference` is the kernel's algorithm in plain torch
(candidate lists, prefixes per threshold, the overflow path, the walk);
tests hold it against the reference scans. It is no path of the port.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

NEG_INF = -1e30


class Thresholds(NamedTuple):
    """IoU thresholds twice: on the host for the checks that branch on
    them, on the device for the arithmetic. Made once before a step is
    captured: a graph cannot hold the copy from pageable host memory that
    a host tensor costs on every call."""

    host: Tensor     # 1-D float32 on the CPU
    device: Tensor   # the same values where the IoU lies


def split_thresholds(thresholds, device) -> Thresholds:
    """``thresholds`` (a sequence, a 1-D tensor anywhere, or a
    :class:`Thresholds`, taken as it is) as a :class:`Thresholds` pair on
    ``device``."""
    if isinstance(thresholds, Thresholds):
        return thresholds
    if isinstance(thresholds, Tensor):
        host = thresholds.detach().to("cpu", torch.float32).reshape(-1)
    else:
        host = torch.tensor(list(thresholds), dtype=torch.float32).reshape(-1)
    return Thresholds(host, host.to(device, non_blocking=True))


def _check_thresholds(thresholds: Tensor) -> None:
    """Refuse t <= 0; checked on the host copy, so the check costs no
    device sync."""
    if thresholds.ndim != 1 or not bool((thresholds.cpu() > 0.0).all()):
        raise ValueError(
            "the matching scan kernel needs 1-D thresholds, all > 0 "
            "(exclusions are folded into zeroed IoU rows), got "
            f"{thresholds.tolist()}")


def scan_loop(iou: Tensor, thresholds: Tensor,
              eligible: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The reference scan body (``matching.py:182-202``) as a loop over the
    N rows of ``iou`` [B, N, G] -> (matched [B, N, T] bool, best [B, N, T]
    int32, -1 where unmatched).

    ``eligible`` [B, N, G] bool adds the explicit exclusions of the scan
    path (real GT, same class, valid detection); without it the IoU is
    taken as pre-masked, as the kernel takes it.
    """
    bsz, n, g = iou.shape
    t = thresholds.shape[0]
    thr = thresholds.to(iou.dtype)[None, :, None]              # [1, T, 1]
    gidx = torch.arange(g, device=iou.device)
    taken = torch.zeros((bsz, t, g), dtype=torch.bool, device=iou.device)
    matched = torch.zeros((bsz, n, t), dtype=torch.bool, device=iou.device)
    best = torch.full((bsz, n, t), -1, dtype=torch.int32, device=iou.device)
    for i in range(n):
        row = iou[:, i, None, :]                                # [B, 1, G]
        elig = (row >= thr) & ~taken
        if eligible is not None:
            elig = elig & eligible[:, i, None, :]
        cand = torch.where(elig, row, torch.full_like(row, NEG_INF))
        mx = cand.amax(dim=2, keepdim=True)                     # [B, T, 1]
        hit = mx[..., 0] > NEG_INF                              # [B, T]
        first = torch.where(elig & (cand == mx), gidx, g).amin(dim=2)
        taken = taken | ((gidx == first[..., None]) & hit[..., None])
        matched[:, i] = hit
        best[:, i] = torch.where(hit, first, -1).to(torch.int32)
    return matched, best


def greedy_scan_reference(iou: Tensor, thresholds):
    """Plain K3 on pre-masked IoU [B, N, G] -> (matched, best) [B, N, T]."""
    thr = split_thresholds(thresholds, iou.device)
    _check_thresholds(thr.host)
    return scan_loop(iou.float(), thr.device.float())


def scan_lists_reference(iou: Tensor, thresholds: Tensor,
                         cap: int = 32) -> tuple[Tensor, Tensor]:
    """The kernel's algorithm in plain torch, on pre-masked IoU [B, N, G]
    -> (matched, best) [B, N, T], the same function as
    :func:`greedy_scan_reference`.

    Each row's candidates at the lowest threshold, ordered by (IoU desc,
    GT index asc), form its list; the candidates at threshold t are the
    list's prefix of IoU >= t. A row with no candidate is unmatched and
    leaves ``taken`` alone. A row with more than ``cap`` candidates takes
    the full-row argmax (the kernel's overflow path). Any other row, per
    threshold, takes the first entry of its prefix whose GT is not taken.
    """
    _check_thresholds(thresholds)
    iou = iou.float()
    thr = thresholds.to(iou.device, torch.float32)
    bsz, n, g = iou.shape
    t = thr.shape[0]
    dev = iou.device
    if g == 0:
        return (torch.zeros((bsz, n, t), dtype=torch.bool, device=dev),
                torch.full((bsz, n, t), -1, dtype=torch.int32, device=dev))
    order = torch.sort(-iou, dim=2, stable=True).indices   # GT asc on ties
    values = torch.gather(iou, 2, order)
    count = (iou >= thr.min()).sum(dim=2)                   # [B, N]
    width = min(cap, g)
    lists, list_v = order[..., :width], values[..., :width]
    entry = torch.arange(width, device=dev)
    gidx = torch.arange(g, device=dev)
    taken = torch.zeros((bsz, t, g), dtype=torch.bool, device=dev)
    matched = torch.zeros((bsz, n, t), dtype=torch.bool, device=dev)
    best = torch.full((bsz, n, t), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        cnt = count[:, i]                                   # [B]
        ids, v = lists[:, i], list_v[:, i]                  # [B, W]
        in_list = entry[None, :] < cnt[:, None]
        # the prefix length per threshold, then the bit test of each entry
        prefix = ((v[:, None, :] >= thr[None, :, None])
                  & in_list[:, None, :]).sum(dim=2)         # [B, T]
        bit = torch.gather(taken, 2, ids[:, None, :].expand(bsz, t, width))
        free = (entry[None, None, :] < prefix[..., None]) & ~bit
        hit = free.any(dim=2)
        first = free.int().argmax(dim=2)                    # first free
        pick = torch.gather(ids, 1, first)                  # [B, T]
        # overflow: the whole row, largest IoU, lowest index on ties
        row = iou[:, i, None, :]                            # [B, 1, G]
        elig = (row >= thr[None, :, None]) & ~taken
        cand = torch.where(elig, row, torch.full_like(row, NEG_INF))
        mx = cand.amax(dim=2, keepdim=True)
        full_hit = elig.any(dim=2)
        full_pick = torch.where(elig & (cand == mx), gidx, g).amin(dim=2)
        over = (cnt > cap)[:, None]
        hit = torch.where(over, full_hit, hit)
        pick = torch.where(over, full_pick, pick)
        taken = taken | ((gidx == pick[..., None]) & hit[..., None])
        matched[:, i] = hit
        best[:, i] = torch.where(hit, pick, -1).to(torch.int32)
    return matched, best


def _library() -> ctypes.CDLL:
    from gossipnet_tpu_torch.ops.cuda import build

    lib = build.load("matching_scan")
    if not getattr(lib, "_gnet_bound", False):
        lib.gnet_greedy_scan_max_g.argtypes = []
        lib.gnet_greedy_scan_max_g.restype = ctypes.c_int
        lib.gnet_greedy_scan.argtypes = ([ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.gnet_greedy_scan.restype = ctypes.c_int
        lib._gnet_bound = True
    return lib


def launch_kernel(iou: Tensor, thresholds,
                  counter=None) -> tuple[Tensor, Tensor]:
    """One scan launch over B images on the current stream ->
    (matched [B, N, T] bool, best [B, N, T] int32); adds one to
    ``counter.launches`` (the calling wrapper) when it launches.
    ``thresholds``: a 1-D tensor or sequence, copied to the card on every
    call, or a :class:`Thresholds` pair, whose device copy is used as it
    is."""
    if iou.device.type != "cuda":
        raise RuntimeError(f"the matching scan kernel needs CUDA tensors, "
                           f"got {iou.device}")
    if iou.ndim != 3 or iou.dtype != torch.float32 or not iou.is_contiguous():
        raise ValueError(f"iou must be a contiguous float32 [B, N, G], got "
                         f"{tuple(iou.shape)} {iou.dtype}")
    pair = (thresholds if isinstance(thresholds, Thresholds)
            else split_thresholds(thresholds, "cpu"))
    _check_thresholds(pair.host)
    bsz, n, g = iou.shape
    t = pair.host.shape[0]
    lib = _library()
    if g > lib.gnet_greedy_scan_max_g() or t > 32:
        raise ValueError(f"the scan kernel takes G <= "
                         f"{lib.gnet_greedy_scan_max_g()} and T <= 32, got "
                         f"G={g}, T={t}")
    if g == 0:   # no GT: nothing to launch, every row unmatched
        return (torch.zeros((bsz, n, t), dtype=torch.bool, device=iou.device),
                torch.full((bsz, n, t), -1, dtype=torch.int32,
                           device=iou.device))
    # the kernel writes every output: no fill launch
    matched = torch.empty((bsz, n, t), dtype=torch.bool, device=iou.device)
    best = torch.empty((bsz, n, t), dtype=torch.int32, device=iou.device)
    # the device copy after the outputs, so they take the blocks a caller
    # freed for them (the check of every output being written relies on it)
    thr = (pair.device if pair.device.device == iou.device
           else pair.host.to(iou.device, non_blocking=True))
    thr = thr.to(torch.float32).contiguous()
    with torch.cuda.device(iou.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gnet_greedy_scan(iou.data_ptr(), thr.data_ptr(),
                                   matched.data_ptr(), best.data_ptr(),
                                   bsz, n, g, t, stream)
    if err != 0:
        raise RuntimeError(f"matching_scan.cu launch failed: CUDA error {err}")
    if counter is not None:
        counter.launches += 1
    return matched, best


def greedy_scan_batched(iou: Tensor, thresholds):
    """K3: batched greedy pass over pre-masked IoU [B, N, G] ->
    (matched [B, N, T] bool, best [B, N, T] int32). Thresholds > 0.
    A launch adds the B x N x T rows it scans to ``rows_launched``."""
    if iou.device.type == "cpu":
        return greedy_scan_reference(iou, thresholds)
    matched, best = launch_kernel(iou, thresholds, greedy_scan_batched)
    if iou.shape[2]:   # G == 0 launches nothing
        greedy_scan_batched.rows_launched += matched.numel()
    return matched, best


def greedy_scan(iou: Tensor, thresholds):
    """K4: the greedy pass for one image, pre-masked IoU [N, G] ->
    (matched [N, T] bool, best [N, T] int32). Thresholds > 0."""
    if iou.device.type == "cpu":
        matched, best = greedy_scan_reference(iou[None], thresholds)
    else:
        matched, best = launch_kernel(iou[None].contiguous(), thresholds,
                                      greedy_scan)
    return matched[0], best[0]


greedy_scan_batched.launches = 0   # K3 launches
greedy_scan_batched.rows_launched = 0   # (image, detection, threshold) rows
greedy_scan.launches = 0           # K4 launches
