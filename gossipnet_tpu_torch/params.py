"""Weights bridge between the JAX package's parameter trees and the port.

The JAX package's serving interchange format is one NPZ of '/'-joined
flax paths (``gossipnet_tpu/utils/export.py``), e.g. ``init_fc/kernel``,
``block_0/reduce/kernel``, ``block_0/pair_wg``, ``head/bias``. This module
reads that format with numpy alone and maps it to a PyTorch ``state_dict``
of :class:`~gossipnet_tpu_torch.models.gossipnet.GossipNet` and back:

- ``block_<k>/...`` <-> ``blocks.<k>....``;
- a Dense ``kernel`` [in, out] <-> ``weight`` [out, in] (transposed);
- a Dense ``bias`` <-> ``bias``; an Embed ``embedding`` <-> ``weight``;
- the raw pair parameters (``pair_wa``, ``pair_wb``, ``pair_wg``,
  ``pair_b1``, ``pair_w2``, ``pair_b2``) keep the JAX orientation, because
  the pair kernel consumes them as they are.

Both directions are exact (a transpose moves no bits).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from gossipnet_tpu_torch.config import ModelConfig
from gossipnet_tpu_torch.ops import pair_features as pf


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


def load_params_npz(path: str | Path) -> dict:
    """A params NPZ written by ``gossipnet_tpu.utils.export.save_params_npz``
    -> nested tree of numpy arrays."""
    with np.load(path) as data:
        return unflatten_paths({k: data[k] for k in data.files})


def _flat(tree_or_flat: Mapping) -> dict:
    if any(isinstance(v, Mapping) for v in tree_or_flat.values()):
        return flatten_paths(tree_or_flat)
    return {k: np.asarray(v) for k, v in tree_or_flat.items()}


_BLOCK = re.compile(r"^block_(\d+)/")


def params_from_jax(tree_or_flat: Mapping) -> dict[str, torch.Tensor]:
    """Flax param tree (or its flat '/'-path dict) of numpy arrays ->
    ``state_dict`` of CPU tensors."""
    sd = {}
    for path, v in _flat(tree_or_flat).items():
        module, _, leaf = path.rpartition("/")
        module = _BLOCK.sub(r"blocks.\1/", module + "/").rstrip("/")
        if leaf == "kernel":
            leaf, v = "weight", v.T
        elif leaf == "embedding":
            leaf = "weight"
        key = f"{module.replace('/', '.')}.{leaf}" if module else leaf
        sd[key] = torch.from_numpy(np.array(v, order="C"))  # a writable copy
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax` -> nested flax tree of numpy."""
    flat = {}
    for key, t in state_dict.items():
        v = t.detach().cpu().numpy()
        module, _, leaf = key.rpartition(".")
        module = re.sub(r"^blocks\.(\d+)", r"block_\1", module)
        if leaf == "weight":
            if module.endswith("class_embed"):
                leaf = "embedding"
            else:
                leaf, v = "kernel", v.T
        path = f"{module.replace('.', '/')}/{leaf}" if module else leaf
        flat[path] = np.ascontiguousarray(v)
    return unflatten_paths(flat)


def as_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A ``state_dict`` as it is, or a JAX tree / flat path dict bridged."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return dict(params)
    return params_from_jax(params)


def init_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Random parameters in the flax tree layout, drawn with numpy from
    ``seed``: LeCun-normal kernels and zero biases, as the flax model
    initialises (the draws differ from jax.random's)."""
    rng = np.random.default_rng(seed)
    fd, rd, p = cfg.feature_dim, cfg.reduced_dim, cfg.pairwise_dim

    def kernel(fan_in, fan_out):
        return (rng.standard_normal((fan_in, fan_out))
                / np.sqrt(fan_in)).astype(np.float32)

    def dense(fan_in, fan_out):
        return {"kernel": kernel(fan_in, fan_out),
                "bias": np.zeros(fan_out, np.float32)}

    tree = {"init_fc": dense(1 + int(cfg.score_rank_feature), fd)}
    g = pf.NUM_PAIR_FEATURES
    for k in range(cfg.num_blocks):
        block = {
            "reduce": dense(fd, rd),
            "pair_wa": kernel(rd, p), "pair_wb": kernel(rd, p),
            "pair_wg": kernel(g, p), "pair_b1": np.zeros(p, np.float32),
            "pair_w2": kernel(p, p), "pair_b2": np.zeros(p, np.float32),
        }
        for i in range(cfg.expand_hidden_layers - 1):
            block["expand" if i == 0 else f"expand_h{i}"] = dense(p, p)
        block["expand_out"] = dense(p, fd)
        tree[f"block_{k}"] = block
    tree["head"] = dense(fd, 1)
    return tree
