"""The PyTorch GossipNet against the JAX one: the golden fixture through
the weights bridge, random parameters on both pool paths, the config copy,
the options the port refuses and those it now runs.

Tolerance for logits: rtol = atol = 1e-4, as tests/test_golden.py holds
the JAX dense path. Both sides compute in IEEE f32 (pair_matmul_dtype
float32); they differ in summation order and in the separable fold of
the kernel path.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch.models.gossipnet import (
    PAD_LOGIT,
    GossipNet,
    check_supported,
)
from gossipnet_tpu_torch.params import flatten_paths, init_params, params_from_jax
from gossipnet_tpu_torch.train import build_model
from tests.test_pallas_kernel import _problem

FIXTURE = Path(__file__).parent / "fixtures" / "golden_config1.npz"
TOL = dict(rtol=1e-4, atol=1e-4)


def _golden():
    data = np.load(FIXTURE)
    flat = {k[len("param:"):]: data[k] for k in data.files
            if k.startswith("param:")}
    return data, flat


@pytest.mark.parametrize("pool_impl", ["dense", "kernel"])
def test_golden_fixture_logits(pool_impl):
    data, flat = _golden()
    cfg = t_config.ModelConfig(num_blocks=1, feature_dim=128, reduced_dim=32,
                               pairwise_dim=32, pair_matmul_dtype="float32")
    model = GossipNet(cfg, pool_impl=pool_impl, device="cpu")
    model.load_state_dict(params_from_jax(flat))
    with torch.inference_mode():
        logits = model(torch.from_numpy(data["boxes"]),
                       torch.from_numpy(data["scores"]),
                       torch.from_numpy(data["valid"]))
    np.testing.assert_allclose(logits.numpy(), data["logits"], **TOL)


def _random_tree(cfg, seed):
    """init_params plus non-zero biases, so every bias path is live."""
    rng = np.random.default_rng(seed + 1)
    flat = flatten_paths(init_params(cfg, seed))
    for k, v in flat.items():
        if k.endswith(("bias", "pair_b1", "pair_b2")):
            flat[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
    return flat


def _jax_logits(cfg_kw, flat, pool_impl, boxes, scores, valid):
    from gossipnet_tpu.utils.export import unflatten_paths

    cfg = j_config.ModelConfig(**cfg_kw)
    params = jax.tree.map(jnp.asarray, unflatten_paths(flat))
    return np.asarray(JGossipNet(cfg, pool_impl=pool_impl).apply(
        {"params": params}, jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(valid)))


@pytest.mark.parametrize("pool_impl", ["dense", "kernel"])
def test_two_block_model_matches_jax(rng, pool_impl):
    cfg_kw = dict(num_blocks=2, feature_dim=32, reduced_dim=16,
                  pairwise_dim=16, expand_hidden_layers=3,
                  pair_matmul_dtype="float32")
    cfg = t_config.ModelConfig(**cfg_kw)
    boxes, scores, valid, _ = _problem(rng, b=2, n=70)
    boxes, scores, valid = (np.array(x) for x in (boxes, scores, valid))
    valid[1, 55:] = False
    valid[0, ::9] = False          # padding rows inside the image too
    flat = _random_tree(cfg, seed=3)
    want = _jax_logits(cfg_kw, flat, "dense" if pool_impl == "dense"
                       else "pallas", boxes, scores, valid)
    model = GossipNet(cfg, pool_impl=pool_impl, device="cpu")
    model.load_state_dict(params_from_jax(flat))
    with torch.inference_mode():
        got = model(torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[~valid] == PAD_LOGIT).all()
    assert np.isfinite(got).all() and np.std(got[valid]) > 1e-3


def test_morton_sort_is_a_pure_permutation(rng):
    """The kernel path's Morton sort + unsort changes no logit: sorting on
    and off agree to f32 noise (the per-row arithmetic is the same)."""
    boxes, scores, valid, _ = _problem(rng, b=2, n=90, n_valid=80)
    args = [torch.from_numpy(np.array(x)) for x in (boxes, scores, valid)]
    out = {}
    for sort in (True, False):
        cfg = t_config.ModelConfig(num_blocks=2, feature_dim=32,
                                   reduced_dim=16, pairwise_dim=16,
                                   pair_matmul_dtype="float32",
                                   sort_detections=sort)
        model = GossipNet(cfg, pool_impl="kernel", device="cpu")
        model.load_state_dict(params_from_jax(_random_tree(cfg, seed=4)))
        with torch.inference_mode():
            out[sort] = model(*args).numpy()
    np.testing.assert_allclose(out[True], out[False], rtol=1e-5, atol=1e-5)


def test_shipped_configs_load_like_jax():
    names = sorted(p.stem for p in
                   (Path(__file__).parents[1] / "experiments").glob("*.yaml"))
    assert "serving_bucketed" in names
    for name in names:
        jc = j_config.load_config(j_config.experiment_path(name))
        tc = t_config.load_config(t_config.experiment_path(name))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
    # the max_detections clamp is kept as it is
    tc = t_config.load_config(None, {"data": {"bucket_sizes": [64, 128]}})
    assert tc.data.max_detections == 128


@pytest.mark.parametrize("override,pool_impl", [
    ({"pair_elementwise_dtype": "bfloat16"}, "kernel"),
    ({"dtype": "bfloat16"}, "dense"),
    ({"dtype": "bfloat16"}, "kernel"),
    ({"dtype": "bfloat16", "pair_elementwise_dtype": "bfloat16"}, "kernel"),
])
def test_precision_knobs_build_and_run(rng, override, pool_impl):
    """The two reduced-precision knobs (``model.dtype``,
    ``pair_elementwise_dtype``) are ported: they build, and on CPU tensors
    run the plain path, forward and backward. Their values against JAX:
    tests/test_torch_precision.py."""
    cfg = t_config.ModelConfig(num_blocks=1, feature_dim=16, reduced_dim=8,
                               pairwise_dim=8, **override)
    check_supported(cfg, pool_impl)
    model = GossipNet(cfg, pool_impl=pool_impl, device="cpu")
    model.load_state_dict(params_from_jax(init_params(cfg)))
    boxes, scores, valid, _ = _problem(rng, b=1, n=24)
    logits = model(*[torch.from_numpy(np.array(x))
                     for x in (boxes, scores, valid)])
    logits.sum().backward()
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert all(p.grad is not None for p in model.parameters())


def test_unknown_model_dtype_raises():
    with pytest.raises(ValueError, match="model.dtype"):
        check_supported(t_config.ModelConfig(dtype="float16"), "dense")


@pytest.mark.parametrize("override,pool_impl", [
    ({"num_classes": 80}, "dense"),
    ({"num_classes": 80}, "kernel"),
    ({"pair_kernel": 1}, "kernel"),
    ({"num_classes": 80, "pair_kernel": 1}, "kernel"),
])
def test_multiclass_and_unfolded_kernel_build_and_run(rng, override,
                                                      pool_impl):
    """The multi-class model and ``pair_kernel: 1`` (K5/K6) are ported:
    they build, and on CPU tensors run their plain versions."""
    cfg = t_config.ModelConfig(num_blocks=1, feature_dim=16, reduced_dim=8,
                               pairwise_dim=8, **override)
    check_supported(cfg, pool_impl)
    model = GossipNet(cfg, pool_impl=pool_impl, device="cpu")
    model.load_state_dict(params_from_jax(init_params(cfg)))
    boxes, scores, valid, _ = _problem(rng, b=1, n=24)
    args = [torch.from_numpy(np.array(x)) for x in (boxes, scores, valid)]
    if cfg.num_classes > 1:
        args.append(torch.from_numpy(rng.integers(0, 80, (1, 24))))
    logits = model(*args)
    logits.sum().backward()
    assert torch.isfinite(logits).all()
    assert all(p.grad is not None for p in model.parameters())


def test_model_defaults_to_cuda_and_raises_without_a_card():
    cfg = t_config.load_config(t_config.experiment_path("serving_bucketed"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, "kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GossipNet(cfg.model)
