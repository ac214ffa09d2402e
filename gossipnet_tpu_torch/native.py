"""ctypes bindings for the host-side C++ library (native/gossip_native.cc);
the port's own copy of ``gossipnet_tpu/native.py``.

Host code: the whole-roidb COCO evaluation matching and the GreedyNMS
sweep in C++. Only the two entries the port calls are bound
(``eval_match_many``, ``greedy_nms_multi``); the library's other entries
(``eval_match``, ``greedy_match``, ``greedy_nms``) and the reference's
``build()`` get a binding when a ported caller needs them. Resolution order:

1. ``GOSSIP_NATIVE_LIB`` env var: explicit path override. A path that is
   set and missing, fails to dlopen or fails the ABI handshake RAISES:
   the caller named that file, so nothing else is tried in its place
   (the reference warns and falls through to the defaults).
2. Repo checkout: ``<repo>/native/libgossip_native.so``
   (``make -C native``).
3. Beside this module: ``gossipnet_tpu_torch/_gossip_native*.so``, where
   a packaging step put one.

A default candidate that fails to dlopen or fails the ABI handshake emits
a RuntimeWarning and resolution falls through to the next one. All
callers have pure-numpy fallbacks, so no usable build at all still
degrades gracefully (but slower). pybind11 is deliberately not used; the
ABI is plain C with a version handshake.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_lib = None
_load_failed = False


def _candidates():
    """Yield (origin, path) in resolution order. The env override is
    always yielded (even if the path is missing) so _load can raise
    on it instead of silently ignoring a typo."""
    env = os.environ.get("GOSSIP_NATIVE_LIB")
    if env:
        yield "GOSSIP_NATIVE_LIB", Path(env)
    yield "repo checkout", _NATIVE_DIR / "libgossip_native.so"
    for cand in sorted(Path(__file__).resolve().parent.glob(
            "_gossip_native*.so")):
        yield "installed package", cand


def _find_lib() -> Path | None:
    """First EXISTING candidate path (diagnostics/tests). The loader
    itself may fall through further if this one fails to dlopen or
    fails the ABI handshake."""
    for _, p in _candidates():
        if p.exists():
            return p
    return None


_ABI_VERSION = 5


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    import warnings

    for origin, lib_path in _candidates():
        explicit = origin == "GOSSIP_NATIVE_LIB"
        if not lib_path.exists():
            if explicit:
                raise FileNotFoundError(
                    f"GOSSIP_NATIVE_LIB={lib_path} does not exist")
            continue
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            if explicit:
                raise
            warnings.warn(
                f"{lib_path} ({origin}) failed to load ({e}); trying "
                "the next candidate", RuntimeWarning)
            continue
        # ABI handshake: a stale prebuilt .so (e.g. the pre-r2 float32
        # eval_match) would silently reinterpret buffers with the wrong
        # element type; refuse anything but the exact expected version
        # (missing symbol == pre-handshake build).
        try:
            lib.gossip_abi_version.restype = ctypes.c_int
            abi = int(lib.gossip_abi_version())
        except AttributeError:
            abi = -1
        if abi != _ABI_VERSION:
            if explicit:
                raise RuntimeError(
                    f"GOSSIP_NATIVE_LIB={lib_path} has ABI {abi}, expected "
                    f"{_ABI_VERSION}; rebuild it with `make -C native`")
            warnings.warn(
                f"{lib_path} ({origin}) has ABI {abi}, expected "
                f"{_ABI_VERSION}; trying the next candidate — rebuild "
                "stale copies with `make -C native`", RuntimeWarning)
            continue
        _bind(lib)
        _lib = lib
        return _lib
    _load_failed = True
    return None


def _bind(lib) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.greedy_nms_multi.argtypes = [
        f64p, f64p, ctypes.c_int, f64p, ctypes.c_int, i32p, i32p,
    ]
    lib.greedy_nms_multi.restype = None
    lib.eval_match_many.argtypes = [
        f64p, f64p, f64p, f64p, u8p,
        i32p, i32p, i32p, i32p, ctypes.c_int,
        f64p, ctypes.c_int, f64p, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.c_int, u8p, u8p, i32p, ctypes.c_int,
    ]
    lib.eval_match_many.restype = None


def available() -> bool:
    return _load() is not None


def eval_match_many(det_boxes, det_areas, gt_boxes, gt_areas, gt_crowd,
                    d_lo, d_hi, g_lo, g_hi, thresholds, area_ranges,
                    max_det, out_off, n_cap_tot, n_threads=1):
    """Whole-roidb batched COCO matching (one C++ call for every
    (image, class) segment x area range — see gossip_native.cc).

    ``n_threads`` shards the independent segments over C++
    std::threads INSIDE the library; results are bit-identical at any
    thread count (disjoint output slices per segment). Host-process
    parallelism deliberately lives here and not in Python: forking a
    warm jax process deadlocks (multiprocessing 'fork' + jax threads).

    Returns (dt_matched, dt_ignore [A, T, n_cap_tot] bool,
    num_gt [A, n_seg] int32). Inputs must follow the packed layout
    documented on the C++ entry; callers check :func:`available`."""
    lib = _load()
    n_seg = len(d_lo)
    t, a = len(thresholds), len(area_ranges)
    dt_matched = np.zeros((a, t, n_cap_tot), np.uint8)
    dt_ignore = np.zeros((a, t, n_cap_tot), np.uint8)
    num_gt = np.zeros((a, max(n_seg, 1)), np.int32)
    if n_seg == 0:
        return (dt_matched.astype(bool), dt_ignore.astype(bool),
                num_gt[:, :0])
    lib.eval_match_many(
        np.ascontiguousarray(det_boxes, np.float64),
        np.ascontiguousarray(det_areas, np.float64),
        np.ascontiguousarray(gt_boxes, np.float64),
        np.ascontiguousarray(gt_areas, np.float64),
        np.ascontiguousarray(gt_crowd, np.uint8),
        np.ascontiguousarray(d_lo, np.int32),
        np.ascontiguousarray(d_hi, np.int32),
        np.ascontiguousarray(g_lo, np.int32),
        np.ascontiguousarray(g_hi, np.int32), n_seg,
        np.ascontiguousarray(thresholds, np.float64), t,
        np.ascontiguousarray(area_ranges, np.float64), a, int(max_det),
        np.ascontiguousarray(out_off, np.int32), int(n_cap_tot),
        dt_matched.reshape(-1), dt_ignore.reshape(-1),
        num_gt.reshape(-1), int(n_threads),
    )
    return dt_matched.astype(bool), dt_ignore.astype(bool), num_gt


def greedy_nms_multi(boxes, scores, thresholds):
    """Greedy-NMS keep indices for MANY thresholds sharing one IoU
    pass (C++ mirror of ops/nms.py::greedy_nms_multi_np, f64
    throughout -> bit-identical keep sets). Returns a list of [k_i]
    int64 arrays, one per threshold, descending score order."""
    lib = _load()
    n, t = len(scores), len(thresholds)
    keep = np.zeros((max(t, 1), n), np.int32)
    nk = np.zeros(max(t, 1), np.int32)
    lib.greedy_nms_multi(
        np.ascontiguousarray(boxes, np.float64),
        np.ascontiguousarray(scores, np.float64),
        n,
        np.ascontiguousarray(thresholds, np.float64),
        t, keep, nk,
    )
    return [keep[i, :nk[i]].astype(np.int64) for i in range(t)]
