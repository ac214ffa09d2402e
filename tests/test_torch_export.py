"""The port's NPZ export and checkpoint-backed Rescorer against the JAX
package on the CPU.

An NPZ written by the port loads in ``gossipnet_tpu.utils.export`` and
gives JAX's scores, and one written by JAX loads in the port, both within
atol = 1e-5 (the JAX dense path and the port's plain kernel path in IEEE
f32, two summation orders); the files themselves hold the same keys and
bit-equal arrays. Scores served from a checkpoint equal those of a
Rescorer built from the saved parameters bit for bit (same arithmetic on
the same weights).
"""

import functools

import jax
import numpy as np
import pytest

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu.utils import export as j_export
from gossipnet_tpu_torch import params as t_params
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.train import build_model, create_train_state
from gossipnet_tpu_torch.utils import export as t_export
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager
from tests.conftest import random_boxes


def _overrides(num_classes=1):
    model = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
             "pairwise_dim": 8, "pair_matmul_dtype": "float32",
             "num_classes": num_classes}
    if num_classes > 1:
        model["class_embed_dim"] = 8
    return {"model": model, "data": {"bucket_sizes": [32, 64]},
            "parallel": {"enable": "off"}}


def _images(rng, num_classes=1, sizes=(6, 30, 50)):
    return [(random_boxes(rng, n, scale=60.0),
             rng.uniform(0, 1, n).astype(np.float32),
             rng.integers(0, num_classes, n).astype(np.int32)
             if num_classes > 1 else None) for n in sizes]


def _jax_params(jcfg, seed):
    args = [np.zeros((1, 32, 4), np.float32), np.zeros((1, 32), np.float32),
            np.ones((1, 32), bool)]
    if jcfg.model.num_classes > 1:
        args.append(np.zeros((1, 32), np.int32))
    return jax.tree.map(np.asarray, j_build_model(jcfg, "dense").init(
        jax.random.key(seed), *args)["params"])


@functools.lru_cache(maxsize=None)
def _jax_rescorer(num_classes):
    """One JAX Rescorer per model, so its compiled shapes are reused;
    each test loads its own params into it with ``reload``."""
    jcfg = j_load_config(None, _overrides(num_classes))
    return JRescorer(jcfg, _jax_params(jcfg, seed=0), pool_impl="dense",
                     mesh=None)


@pytest.mark.parametrize("num_classes", [1, 3], ids=["persons", "classes3"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_crosses_between_the_packages(tmp_path, rng, writer,
                                          num_classes):
    """The NPZ one package writes serves the other's scores."""
    ov = _overrides(num_classes)
    jcfg, cfg = j_load_config(None, ov), load_config(None, ov)
    jr = _jax_rescorer(num_classes)
    images = _images(rng, num_classes)
    path = tmp_path / "params.npz"
    if writer == "port":
        sd = as_state_dict(init_params(cfg.model, seed=3))
        t_export.save_params_npz(path, sd)
        got = Rescorer(cfg, sd, pool_impl="kernel",
                       device="cpu").rescore_batch(images)
        jr.reload(j_export.load_params_npz(path))
        want = jr.rescore_batch(images)
    else:
        params = _jax_params(jcfg, seed=3)
        j_export.save_params_npz(path, params)
        jr.reload(params)
        want = jr.rescore_batch(images)
        got = Rescorer(cfg, t_export.load_params_npz(path),
                       pool_impl="kernel", device="cpu").rescore_batch(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_npz_files_are_the_same_bits(tmp_path):
    """A state_dict written by the port and the same tree written by JAX
    hold the same keys and bit-equal arrays; the helpers stay importable
    from params.py."""
    jcfg = j_load_config(None, _overrides())
    params = _jax_params(jcfg, seed=4)
    j_export.save_params_npz(tmp_path / "jax.npz", params)
    t_export.save_params_npz(tmp_path / "port.npz",
                             t_params.params_from_jax(params))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    assert t_params.load_params_npz is t_export.load_params_npz
    assert t_params.flatten_paths is t_export.flatten_paths


def _checkpoints(tmp_path, cfg, best_seed=1, latest_seed=2, best=True):
    """A checkpoint dir whose best state holds init_params(best_seed) and
    whose latest periodic step holds init_params(latest_seed)."""
    ckpt = CheckpointManager(tmp_path / "ckpt")
    model = build_model(cfg, "dense", "cpu")
    if best:
        ckpt.maybe_save_best(0.5, create_train_state(cfg, model,
                                                     seed=best_seed))
    ckpt.save(7, create_train_state(cfg, model, seed=latest_seed))
    return tmp_path / "ckpt"


def _want(cfg, seed, images):
    return Rescorer(cfg, init_params(cfg.model, seed), pool_impl="kernel",
                    device="cpu").rescore_batch(images)


def test_from_checkpoint_serves_best_then_latest(tmp_path, rng):
    cfg = load_config(None, _overrides())
    d = _checkpoints(tmp_path, cfg)
    images = _images(rng)
    best, latest = _want(cfg, 1, images), _want(cfg, 2, images)
    r = Rescorer.from_checkpoint(cfg, str(d), pool_impl="kernel",
                                 device="cpu")
    for g, w in zip(r.rescore_batch(images), best):
        np.testing.assert_array_equal(g, w)
    r.reload(checkpoint_dir=str(d), best=False)
    for g, w in zip(r.rescore_batch(images), latest):
        np.testing.assert_array_equal(g, w)
    r.reload(checkpoint_dir=str(d))
    for g, w in zip(r.rescore_batch(images), best):
        np.testing.assert_array_equal(g, w)
    sd = Rescorer.load_checkpoint_params(cfg, str(d), best=False)
    assert all(t.device.type == "cpu" for t in sd.values())


def test_without_a_best_checkpoint_the_latest_is_served(tmp_path, rng):
    cfg = load_config(None, _overrides())
    d = _checkpoints(tmp_path, cfg, best=False)
    images = _images(rng)
    got = Rescorer.from_checkpoint(cfg, str(d), pool_impl="kernel",
                                   device="cpu").rescore_batch(images)
    for g, w in zip(got, _want(cfg, 2, images)):
        np.testing.assert_array_equal(g, w)


def test_a_missing_checkpoint_names_the_directory(tmp_path):
    cfg = load_config(None, _overrides())
    for d in (tmp_path / "absent", tmp_path):
        with pytest.raises(FileNotFoundError, match=str(d)):
            Rescorer.load_checkpoint_params(cfg, str(d))
    assert not (tmp_path / "absent").exists()   # nothing was created


@pytest.mark.parametrize("args", [{}, {"params": "p", "checkpoint_dir": "x"}],
                         ids=["neither", "both"])
def test_reload_takes_exactly_one_source(args):
    """The same refusal, word for word, as the reference's reload."""
    jr = _jax_rescorer(1)
    params = _jax_params(jr.cfg, seed=0)
    r = Rescorer(load_config(None, _overrides()), params, pool_impl="kernel",
                 device="cpu")
    if "params" in args:
        args = dict(args, params=params)
    with pytest.raises(ValueError) as want:
        jr.reload(**args)
    with pytest.raises(ValueError, match="exactly one") as got:
        r.reload(**args)
    assert str(got.value) == str(want.value)
