"""The weights bridge: JAX parameter trees <-> the port's state_dict."""

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import jax
import pytest
import torch

from gossipnet_tpu.config import ModelConfig as JModelConfig
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu.utils.export import save_params_npz
from gossipnet_tpu_torch.config import ModelConfig
from gossipnet_tpu_torch.models.gossipnet import GossipNet
from gossipnet_tpu_torch.params import (
    flatten_paths,
    init_params,
    load_params_npz,
    params_from_jax,
    params_to_jax,
    unflatten_paths,
)

CFG = dict(num_blocks=2, feature_dim=24, reduced_dim=8, pairwise_dim=8)


def _jax_params(**kw):
    cfg = JModelConfig(**{**CFG, **kw})
    n = 16
    params = JGossipNet(cfg).init(
        jax.random.key(0), np.zeros((1, n, 4), np.float32),
        np.zeros((1, n), np.float32), np.ones((1, n), bool))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("hidden", [1, 2, 3])
def test_round_trip_is_bit_identical(hidden):
    tree = _jax_params(expand_hidden_layers=hidden)
    sd = params_from_jax(tree)
    back = flatten_paths(params_to_jax(sd))
    want = flatten_paths(tree)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # and the state_dict is exactly what the port's model holds
    model = GossipNet(ModelConfig(**CFG, expand_hidden_layers=hidden),
                      device="cpu")
    want_sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want_sd.items()}
    model.load_state_dict(sd)


def test_orientation():
    tree = _jax_params()
    sd = params_from_jax(tree)
    # Dense kernels [in, out] become nn.Linear weights [out, in] ...
    np.testing.assert_array_equal(sd["blocks.0.reduce.weight"].numpy(),
                                  tree["block_0"]["reduce"]["kernel"].T)
    np.testing.assert_array_equal(sd["init_fc.weight"].numpy(),
                                  tree["init_fc"]["kernel"].T)
    # ... the raw pair parameters keep the JAX orientation.
    for name in ("pair_wa", "pair_wb", "pair_wg", "pair_w2"):
        np.testing.assert_array_equal(sd[f"blocks.1.{name}"].numpy(),
                                      tree["block_1"][name])


def test_npz_from_jax_export_loads(tmp_path):
    tree = _jax_params()
    path = tmp_path / "params.npz"
    save_params_npz(path, tree)
    loaded = load_params_npz(path)
    assert flatten_paths(loaded).keys() == flatten_paths(tree).keys()
    for k, v in flatten_paths(tree).items():
        np.testing.assert_array_equal(flatten_paths(loaded)[k], v)
    GossipNet(ModelConfig(**CFG), device="cpu").load_state_dict(
        params_from_jax(loaded))
    # a flat '/'-path dict is accepted as well as a tree
    flat_sd = params_from_jax(flatten_paths(tree))
    assert all(torch.equal(flat_sd[k], v)
               for k, v in params_from_jax(loaded).items())


def test_init_params_has_the_flax_layout():
    for hidden in (1, 2, 3):
        want = flatten_paths(_jax_params(expand_hidden_layers=hidden))
        got = flatten_paths(init_params(
            ModelConfig(**CFG, expand_hidden_layers=hidden), seed=0))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert all(v.dtype == np.float32 for v in got.values())
    a = flatten_paths(init_params(ModelConfig(**CFG), seed=1))
    b = flatten_paths(init_params(ModelConfig(**CFG), seed=1))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_unflatten_inverts_flatten():
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros(1)}}, "e": np.ones(3)}
    back = unflatten_paths(flatten_paths(tree))
    assert back["a"]["c"]["d"].shape == (1,) and back["e"].shape == (3,)
