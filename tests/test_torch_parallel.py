"""The port's device mesh (``gossipnet_tpu_torch/parallel/``) against the
JAX package's (``gossipnet_tpu/parallel/``) on the CPU: the counterparts
of ``tests/test_sharding.py``.

The port's ranks are gloo worlds of spawned processes
(``parallel.world.run_world``) running the rank programs of
``parallel/legs.py`` with the kernels' plain versions; one world of two
and one of four ranks serve every case of this file. The JAX references
run in this process on its simulated CPU devices (``tests/conftest.py``),
from the same seeded numpy parameters and batches. The mesh shapes are
the JAX tests' where a world of four has them; (2 x 2) stands for their
(4 x 2).

Tolerances: the sharded forward against JAX's ``make_sharded_inference``
on the same mesh shape, 2e-4 (the JAX tests' own, Pallas interpret mode
against the port's plain kernels); raw gradients against the local
gradient, rtol 5e-4 and atol 5e-6 (the JAX tests'); one Adam step,
against JAX's local step, 1e-4 on the loss and rtol 5e-3, atol 5e-4 on
the parameters (the JAX test's), and 1e-6 against the port's own local
step; the mesh evaluation's stats against the single-device stats, rtol
1e-5 and atol 1e-6 (the JAX test's). The row gather is bit-exact.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu import train as j_train
from gossipnet_tpu.evaluate import evaluate_model as j_evaluate_model
from gossipnet_tpu.losses import matching_loss as j_matching_loss
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu.parallel.sharding import make_mesh as j_make_mesh
from gossipnet_tpu.parallel.sharding import (
    make_sharded_inference as j_make_sharded_inference,
)
from gossipnet_tpu.utils.export import unflatten_paths
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.params import (
    as_state_dict,
    flatten_paths,
    init_params,
    params_to_jax,
)
from gossipnet_tpu_torch.parallel import legs
from gossipnet_tpu_torch.parallel.spmd import gossipnet_sharded_forward
from gossipnet_tpu_torch.parallel.world import run_world

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)
EVAL_DATA = dict(num_images=12, seed=7)


def _overrides(**model):
    return {"model": {"num_blocks": 2, "feature_dim": 32, "reduced_dim": 16,
                      "pairwise_dim": 16, "pair_matmul_dtype": "float32",
                      **model},
            "train": {"batch_size": 8, "learning_rate": 1e-3, "seed": 0},
            "data": {"bucket_sizes": [64, 128]},
            "parallel": {"enable": "off"}}


def _params(ov, seed=0):
    """init_params with non-zero biases, so every bias path is live."""
    cfg = t_config.load_config(None, ov)
    rng = np.random.default_rng(seed + 7)
    flat = flatten_paths(init_params(cfg.model, seed=seed))
    for k, v in flat.items():
        if k.endswith(("bias", "pair_b1", "pair_b2")):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return flat


def _batch(ov, seed=0):
    cfg = t_config.load_config(None, ov)
    roidb = synthetic_roidb(num_images=16, seed=seed,
                            num_classes=cfg.model.num_classes)
    it = BatchIterator(roidb, cfg.train.batch_size, cfg.data.bucket_sizes,
                       seed=0)
    return t_train.host_arrays(next(it))


OV, OV_MC = _overrides(), _overrides(num_classes=4)
PARAMS, PARAMS_MC = _params(OV), _params(OV_MC)
ARRAYS, ARRAYS_MC = _batch(OV), _batch(OV_MC)
INPUTS = ("boxes", "scores", "valid", "classes")


def _leg(name, leg, **kw):
    return (name, leg, kw)


def _world(size, plan):
    return run_world(legs.run_legs, size, args=(plan,), timeout_s=240)


@pytest.fixture(scope="module")
def world2():
    """Every case of a world of two ranks, run once."""
    return _world(2, [
        _leg("fwd_1x2", legs.forward, overrides=OV, params=PARAMS,
             arrays={k: ARRAYS[k] for k in INPUTS}, shape=(1, 2)),
        _leg("grads_1x2", legs.grads, overrides=OV, params=PARAMS,
             arrays=ARRAYS, shape=(1, 2)),
        _leg("gather_1x2", legs.gather_exact, shape=(1, 2)),
    ])


@pytest.fixture(scope="module")
def world4():
    """Every case of a world of four ranks, run once."""
    return _world(4, [
        _leg("fwd_2x2", legs.forward, overrides=OV, params=PARAMS,
             arrays={k: ARRAYS[k] for k in INPUTS}, shape=(2, 2)),
        _leg("fwd_mc_2x2", legs.forward, overrides=OV_MC, params=PARAMS_MC,
             arrays={k: ARRAYS_MC[k] for k in INPUTS}, shape=(2, 2)),
        _leg("grads_2x2", legs.grads, overrides=OV, params=PARAMS,
             arrays=ARRAYS, shape=(2, 2)),
        _leg("grads_4x1", legs.grads, overrides=OV, params=PARAMS,
             arrays=ARRAYS, shape=(4, 1)),
        _leg("step_2x2", legs.train_steps, overrides=OV, params=PARAMS,
             batches=[ARRAYS], shape=(2, 2)),
        _leg("eval_2x2", legs.evaluate, overrides=OV, params=PARAMS,
             data=EVAL_DATA, shape=(2, 2), batch_size=8),
        _leg("gather_2x2", legs.gather_exact, shape=(2, 2)),
        _leg("gather_1x4", legs.gather_exact, shape=(1, 4)),
    ])


def _jax(ov, params):
    jc = j_config.load_config(None, ov)
    return jc, jax.tree.map(jnp.asarray, unflatten_paths(params))


def _jax_sharded(ov, params, arrays, n_data, n_det):
    jc, jp = _jax(ov, params)
    mesh = j_make_mesh(n_data, n_det,
                       devices=jax.devices()[:n_data * n_det])
    fwd = j_make_sharded_inference(jc, mesh, interpret=True)
    return np.asarray(fwd(jp, {k: jnp.asarray(arrays[k]) for k in INPUTS}))


@pytest.fixture(scope="module")
def local_grads():
    """JAX's gradient of the local (dense) loss on the batch."""
    jc, jp = _jax(OV, PARAMS)
    model = JGossipNet(jc.model, pool_impl="dense")
    batch = {k: jnp.asarray(v) for k, v in ARRAYS.items()}

    def loss_fn(p):
        logits = model.apply({"params": p}, batch["boxes"], batch["scores"],
                             batch["valid"])
        return j_matching_loss(logits, batch, jc)[0]

    grads = jax.jit(jax.grad(loss_fn))(jp)
    return flatten_paths(jax.tree.map(np.asarray, grads))


def _by_jax_path(grads: dict) -> dict:
    return flatten_paths(params_to_jax(
        {k: torch.from_numpy(v) for k, v in grads.items()}))


def test_sharded_forward_matches_module_single_shard():
    """No mesh: the sharded forward at one shard against the JAX module
    and bit for bit against the port's own local forward."""
    cfg = t_config.load_config(None, OV)
    model = t_train.build_model(cfg, "kernel", "cpu")
    model.load_state_dict(as_state_dict(PARAMS))
    t = {k: torch.from_numpy(ARRAYS[k]) for k in INPUTS}
    with torch.no_grad():
        got = gossipnet_sharded_forward(model, t["boxes"], t["scores"],
                                        t["valid"])
        local = model(t["boxes"], t["scores"], t["valid"])
    torch.testing.assert_close(got, local, rtol=0, atol=0)
    jc, jp = _jax(OV, PARAMS)
    ref = jax.jit(JGossipNet(jc.model, pool_impl="dense").apply)(
        {"params": jp}, *(jnp.asarray(ARRAYS[k]) for k in INPUTS[:3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_sharded_forward_matches_across_det_shards(world2):
    """mesh (1, 2): the row-sharded pair stage on both ranks."""
    want = _jax_sharded(OV, PARAMS, ARRAYS, 1, 2)
    for rank in world2:
        np.testing.assert_allclose(rank["fwd_1x2"]["result"], want,
                                   **FWD_TOL)


def test_sharded_inference_dp_and_det(world4):
    """(2 x 2): the batch over 'data', the rows over 'det'."""
    want = _jax_sharded(OV, PARAMS, ARRAYS, 2, 2)
    got = [rank["fwd_2x2"]["result"] for rank in world4]
    for g in got:
        np.testing.assert_allclose(g, want, **FWD_TOL)
        np.testing.assert_array_equal(g, got[0])   # every rank the same


def test_sharded_forward_multiclass(world4):
    want = _jax_sharded(OV_MC, PARAMS_MC, ARRAYS_MC, 2, 2)
    for rank in world4:
        np.testing.assert_allclose(rank["fwd_mc_2x2"]["result"], want,
                                   **FWD_TOL)


@pytest.mark.parametrize("n_data,n_det", [(1, 2), (2, 2), (4, 1)])
def test_sharded_raw_grads_match_local(world2, world4, local_grads, n_data,
                                      n_det):
    """The closure is a mean over 'det' (the gather's backward already
    sums the n_det copies of the loss) and a mean over 'data': a wrong
    scale shows here, where Adam would hide it."""
    world = world2 if n_data * n_det == 2 else world4
    want = local_grads
    ranks = [_by_jax_path(r[f"grads_{n_data}x{n_det}"]["result"][0])
             for r in world]
    assert sorted(ranks[0]) == sorted(want)
    for got in ranks:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **GRAD_TOL,
                                       err_msg=k)
            np.testing.assert_array_equal(got[k], ranks[0][k])


def test_sharded_train_step_matches_local(world4):
    """One Adam step on (2 x 2) against JAX's local step and the port's."""
    jc, jp = _jax(OV, PARAMS)
    jmodel = JGossipNet(jc.model, pool_impl="dense")
    jstate = j_train.TrainState.create(
        apply_fn=jmodel.apply, params=jp, tx=j_train.make_optimizer(jc),
        rng=jax.random.key(0))
    jstate, jm = j_train.train_step(
        jstate, {k: jnp.asarray(v) for k, v in ARRAYS.items()}, jc)
    want = flatten_paths(jax.tree.map(np.asarray, jstate.params))

    cfg = t_config.load_config(None, OV)
    state = t_train.create_train_state(
        cfg, t_train.build_model(cfg, "kernel", "cpu"), params=PARAMS)
    state, lm = t_train.train_step(
        state, {k: torch.from_numpy(v) for k, v in ARRAYS.items()}, cfg)
    local = flatten_paths(params_to_jax(state.model.state_dict()))
    for rank in world4:
        params, (metrics,) = rank["step_2x2"]["result"]
        np.testing.assert_allclose(metrics["loss"], float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(metrics["loss"], float(lm["loss"]),
                                   rtol=1e-6)
        got = _by_jax_path(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       atol=5e-4, err_msg=k)
            np.testing.assert_allclose(got[k], local[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_mesh_eval_matches_single_device_eval(world4):
    """evaluate_model through sharded_forward_fn on (2 x 2) reproduces
    the single-device stats."""
    from gossipnet_tpu.data.synthetic import synthetic_roidb as j_roidb

    jc, jp = _jax(OV, PARAMS)
    want = j_evaluate_model(jp, JGossipNet(jc.model, pool_impl="dense"),
                            j_roidb(**EVAL_DATA), batch_size=8,
                            bucket_sizes=(64, 128))
    for rank in world4:
        got = rank["eval_2x2"]["result"]["stats"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("size,shape", [(2, (1, 2)), (4, (2, 2)),
                                        (4, (1, 4))])
def test_row_gather_and_its_backward_are_exact(world2, world4, size, shape):
    world = world2 if size == 2 else world4
    tag = f"gather_{shape[0]}x{shape[1]}"
    assert all(rank[tag]["result"] for rank in world)


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(legs.run_legs, 2, timeout_s=120,
                  args=([_leg("fail", legs.fail, rank=1)],))
    assert time.monotonic() - t0 < 60   # the barrier's peer was killed


def test_a_world_past_its_timeout_is_killed():
    with pytest.raises(TimeoutError):
        run_world(legs.run_legs, 2, timeout_s=0.5,
                  args=([_leg("gather", legs.gather_exact, shape=(1, 2))],))


@pytest.mark.parametrize("b,n", [(8, 1024), (2, 4096)])
def test_a_row_shard_splits_its_columns_as_the_square_launch(monkeypatch, b,
                                                             n):
    """The backwards' split count follows the whole pair matrix, so a det
    shard's K2/K6 adds each row's partials in the square launch's order
    (the shard gate holds d_a' bit-equal on the card): at the bench batch
    and config 4's, a shard's own row tiles would give more, and the
    forwards (K1/K5, an order-free max) keep those."""
    from gossipnet_tpu_torch.ops.cuda import launch, pairwise, pairwise2

    monkeypatch.setattr(launch, "_sm_count", lambda index: 132)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (b, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 20], -1))
    cols = pf.stack_columns(pf.det_columns(
        boxes, torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(
            np.float32)), torch.ones(b, n, dtype=torch.bool)))
    for build in (pairwise2.pair_geometry, pairwise.pair_columns):
        square = launch._splits(build(cols, cols, 0.2), torch.device("cpu"))
        for n_det in (2, 4):
            shard = build(cols[:, :, :n // n_det].contiguous(), cols, 0.2)
            nb, ni, nj = shard.flags.shape
            own = launch.col_splits(nb * ni, nj, 132)
            assert launch._splits(shard, torch.device("cpu"),
                                  whole_matrix=True) == square
            assert launch._splits(shard, torch.device("cpu")) == own
            assert own > square
