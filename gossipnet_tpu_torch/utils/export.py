"""Portable parameter export/import as one NPZ file (port of
``gossipnet_tpu/utils/export.py``).

Checkpoints (``utils/checkpoint.py``) are the training format; this is the
serving interchange format that both packages read and write: one flat
NPZ whose keys are the JAX parameter tree's '/'-joined paths
(``init_fc/kernel``, ``block_0/pair_wg``, ...), loadable anywhere numpy
exists. A PyTorch ``state_dict`` goes out through the bridge of
``params.py`` in the reference's orientation, so an NPZ written here loads
in ``gossipnet_tpu.utils.export.load_params_npz`` and back.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np


def flatten_paths(tree: Mapping) -> dict:
    """Nested dict tree -> {'a/b/c': numpy leaf}."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, path)
            else:
                flat[path] = np.asarray(v)

    walk(tree, "")
    return flat


def unflatten_paths(flat: Mapping) -> dict:
    """Inverse of :func:`flatten_paths` (the NPZ key convention)."""
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str | Path, params) -> None:
    """Write ``params`` (a ``state_dict`` or a JAX tree of numpy arrays)
    as the reference's NPZ of '/'-joined JAX paths."""
    from gossipnet_tpu_torch.params import as_state_dict, params_to_jax

    np.savez_compressed(path,
                        **flatten_paths(params_to_jax(as_state_dict(params))))


def load_params_npz(path: str | Path) -> dict:
    """A params NPZ (written here or by the JAX package) -> nested tree of
    numpy arrays, which ``Rescorer`` and ``as_state_dict`` take."""
    with np.load(path) as data:
        return unflatten_paths({k: data[k] for k in data.files})
