"""train.py of the port against gossipnet_tpu.train on the CPU: the
learning-rate schedules, the optimizer trajectories from bridged JAX
parameters, the data stream, checkpoint resume and the preemption path,
and remat.

The trajectories run the port's ``train_step`` on ``pool_impl="kernel"``
(on CPU tensors K1's and K2's plain versions, through the autograd
Function) against the JAX ``train_step`` on ``pool_impl="dense"``. The
inputs are continuous random boxes and weights, so no two neighbour pairs
tie exactly and the dense path's split of tied gradients never applies.
Tolerance 1e-5 (rtol and atol) on the parameters and the metrics: both
sides compute in IEEE f32 and differ in summation order.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu import train as j_train
from gossipnet_tpu.data.bucketing import BatchIterator as JIterator
from gossipnet_tpu.data.synthetic import synthetic_roidb as j_roidb
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.params import (
    flatten_paths,
    init_params,
    params_to_jax,
)
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

TOL = dict(rtol=1e-5, atol=1e-5)
DATA = dict(num_images=6, seed=0, num_gt=5, dets_per_gt=5, num_clutter=6)


def _overrides(**train):
    return {
        "model": {"num_blocks": 2, "feature_dim": 32, "reduced_dim": 16,
                  "pairwise_dim": 16, "pair_matmul_dtype": "float32"},
        "data": {"bucket_sizes": [32, 64]},
        "parallel": {"enable": "off"},
        "train": {"batch_size": 2, "log_every": 1000, "snapshot_every": 0,
                  "eval_every": 0, **train},
    }


def _configs(**train):
    ov = _overrides(**train)
    return j_config.load_config(None, ov), t_config.load_config(None, ov)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [
    dict(lr_schedule="constant", learning_rate=3e-3),
    dict(lr_schedule="step", lr_decay_steps=[6, 7, 12], lr_decay_rate=0.5,
         grad_accum_steps=3),
    dict(lr_schedule="cosine", max_steps=40, warmup_steps=8),
    dict(lr_schedule="cosine", max_steps=40, warmup_steps=8,
         grad_accum_steps=2),
], ids=["constant", "step_colliding", "cosine_warmup", "cosine_warmup_accum"])
def test_lr_schedule_matches_optax(train):
    jc, tc = _configs(**train)
    want, got = j_train.make_lr_schedule(jc), t_train.make_lr_schedule(tc)
    for count in range(45):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


def test_step_boundaries_compound_when_they_collide():
    _, tc = _configs(lr_schedule="step", lr_decay_steps=[6, 7],
                     lr_decay_rate=0.5, grad_accum_steps=3,
                     learning_rate=1.0)
    sched = t_train.make_lr_schedule(tc)
    assert sched(1) == 1.0 and sched(2) == 0.25   # 6//3 == 7//3 == 2


# ---------------------------------------------------------------------------
# trajectories against JAX
# ---------------------------------------------------------------------------


def _batches(tc, n):
    it = BatchIterator(synthetic_roidb(**DATA), tc.train.batch_size,
                       tc.data.bucket_sizes, seed=0)
    return [next(it) for _ in range(n)]


def _random_tree(cfg):
    """init_params with non-zero biases, so every bias path is live."""
    rng = np.random.default_rng(7)
    flat = flatten_paths(init_params(cfg, seed=3))
    for k, v in flat.items():
        if k.endswith(("bias", "pair_b1", "pair_b2")):
            flat[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
    return flat


def _trajectories(steps=5, **train):
    jc, tc = _configs(**train)
    flat = _random_tree(tc.model)
    from gossipnet_tpu.utils.export import unflatten_paths

    jparams = jax.tree.map(jnp.asarray, unflatten_paths(flat))
    jmodel = JGossipNet(jc.model, pool_impl="dense")
    jstate = j_train.TrainState.create(
        apply_fn=jmodel.apply, params=jparams,
        tx=j_train.make_optimizer(jc), rng=jax.random.key(0))
    model = t_train.build_model(tc, "kernel", "cpu")
    state = t_train.create_train_state(tc, model, params=flat)
    jm, tm = [], []
    for batch in _batches(tc, steps):
        arrays = {k: jnp.asarray(getattr(batch, k))
                  for k in t_train.BATCH_KEYS}
        jstate, m = j_train.train_step(jstate, arrays, jc)
        jm.append({k: float(v) for k, v in m.items()})
        state, m = t_train.train_step(
            state, t_train.batch_to_device(batch, "cpu"), tc)
        tm.append({k: float(v) for k, v in m.items()})
    return jstate, state, jm, tm


def _assert_trajectories_agree(jstate, state, jm, tm):
    for want, got in zip(jm, tm):
        for k in ("loss", "pos_frac", "num_pos", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    want = flatten_paths(jax.tree.map(np.asarray, jstate.params))
    got = flatten_paths(params_to_jax(state.model.state_dict()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_sgd_trajectory_with_clipping_and_accumulation_matches_jax():
    """SGD is scale-sensitive: a wrong gradient scale, clip rule or
    accumulation mean shows in the parameters."""
    jstate, state, jm, tm = _trajectories(
        optimizer="sgd", learning_rate=0.05, grad_clip_norm=0.2,
        grad_accum_steps=2)
    _assert_trajectories_agree(jstate, state, jm, tm)
    assert max(m["grad_norm"] for m in tm) > 0.2   # clipping was live
    assert state.step == 5 and state.optimizer.param_groups[0]["count"] == 2


def test_adam_trajectory_matches_jax():
    jstate, state, jm, tm = _trajectories(
        optimizer="adam", learning_rate=3e-3, grad_clip_norm=10.0,
        lr_schedule="cosine", max_steps=8, warmup_steps=2)
    _assert_trajectories_agree(jstate, state, jm, tm)


def test_adamw_trajectory_matches_jax():
    jstate, state, jm, tm = _trajectories(
        steps=3, optimizer="adamw", learning_rate=3e-3, weight_decay=0.1)
    _assert_trajectories_agree(jstate, state, jm, tm)


def test_batch_stream_matches_jax():
    kw = dict(num_images=11, seed=4, num_gt=3, dets_per_gt=4, num_clutter=3)
    mine = BatchIterator(synthetic_roidb(**kw), 4, (16, 32, 64), seed=2)
    ref = JIterator(j_roidb(**kw), 4, (16, 32, 64), seed=2)
    for _ in range(9):                       # across an epoch boundary
        a, b = next(mine), next(ref)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert mine.get_state() == ref.get_state()
    mine.set_state({"epoch": 0, "cursor": 2, "seed": 2})
    ref.set_state({"epoch": 0, "cursor": 2, "seed": 2})
    np.testing.assert_array_equal(next(mine).boxes, next(ref).boxes)
    with pytest.raises(ValueError, match="seed"):
        mine.set_state({"epoch": 0, "cursor": 0, "seed": 3})


# ---------------------------------------------------------------------------
# the loop: resume, preemption, remat, unported options
# ---------------------------------------------------------------------------


def _loop_cfg(tmp_path, name, **train):
    return t_config.load_config(None, _overrides(
        checkpoint_dir=str(tmp_path / name), learning_rate=3e-3,
        keep_checkpoints=2, **train))


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _assert_same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """20 steps straight against 10 + resume + 10: identical parameters,
    optimizer state and step; periodic checkpoints are pruned."""
    roidb = synthetic_roidb(**DATA)
    straight = t_train.train(_loop_cfg(tmp_path, "a"), roidb, max_steps=20,
                             device="cpu")
    cfg_b = _loop_cfg(tmp_path, "b", snapshot_every=4)
    t_train.train(cfg_b, roidb, max_steps=10, device="cpu")
    ckpt = CheckpointManager(cfg_b.train.checkpoint_dir, max_to_keep=2)
    assert ckpt.all_steps() == [8, 10]
    assert sorted(p.name for p in ckpt.directory.glob("host_*.json")) == \
        ["host_10.json", "host_8.json"]
    resumed = t_train.train(cfg_b, roidb, max_steps=20, device="cpu")
    assert resumed.step == straight.step == 20
    _assert_same_params(_params(straight), _params(resumed))
    a = straight.optimizer.state_dict()
    b = resumed.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k])


def test_preemption_stop_checkpoints_and_resumes_bit_exact(tmp_path):
    roidb = synthetic_roidb(**DATA)
    straight = t_train.train(_loop_cfg(tmp_path, "a"), roidb, max_steps=12,
                             device="cpu")
    cfg_b = _loop_cfg(tmp_path, "b")
    polls = iter(range(1000))
    mid = t_train.train(cfg_b, roidb, max_steps=12, device="cpu",
                        stop=lambda: next(polls) >= 5)
    assert 0 < mid.step < 12
    assert CheckpointManager(cfg_b.train.checkpoint_dir).latest_step() == \
        mid.step
    resumed = t_train.train(cfg_b, roidb, max_steps=12, device="cpu")
    assert resumed.step == 12
    _assert_same_params(_params(straight), _params(resumed))


def test_steps_per_call_groups_and_metrics(tmp_path):
    """steps_per_call > 1 groups same-shape batches; logged metrics are the
    group means (grad_norm the last step's), and the run still trains
    exactly max_steps batches."""
    roidb = synthetic_roidb(**DATA)
    path = tmp_path / "m.jsonl"
    state = t_train.train(_loop_cfg(tmp_path, "g", steps_per_call=2,
                                    log_every=1),
                          roidb, max_steps=5, device="cpu",
                          metrics_path=str(path))
    assert state.step == 5
    import json

    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_best_checkpoint_follows_val_ap(tmp_path):
    roidb = synthetic_roidb(**DATA)
    aps = iter([0.3, 0.2, 0.5])
    t_train.train(_loop_cfg(tmp_path, "best", eval_every=2), roidb,
                  max_steps=6, device="cpu",
                  eval_fn=lambda st: {"AP": next(aps)})
    ckpt_dir = tmp_path / "best"
    assert (ckpt_dir / "best" / "state.pt").exists()
    import json

    assert json.loads((ckpt_dir / "best.json").read_text()) == {"metric": 0.5}


def test_remat_blocks_give_the_same_gradients():
    _, tc = _configs()
    flat = _random_tree(tc.model)
    batch = t_train.batch_to_device(_batches(tc, 1)[0], "cpu")
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(
            tc, train=dataclasses.replace(tc.train, remat_blocks=remat))
        model = t_train.build_model(cfg, "kernel", "cpu")
        assert model.remat is remat
        t_train.create_train_state(cfg, model, params=flat)
        loss, _ = t_train.loss_and_metrics(model, batch, cfg)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)


@pytest.mark.parametrize("override", [
    {"parallel": {"enable": "on"}},
    {"data": {"dataset": "coco"}},
], ids=["mesh_on", "coco"])
def test_coco_data_profiling_and_a_one_device_mesh_train(tmp_path,
                                                         override):
    """``dataset: coco``, a profiled run and ``parallel.enable: "on"``
    train: the COCO loaders fail only on the annotation file that is not
    there, a profiled run trains, and ``on`` with the default axes trains
    on a 1 x 1 mesh (a world of one in this process, taken down after) to
    the parameters of the run off the mesh (1e-6)."""
    if "data" in override:
        override = {"data": {"dataset": "coco",
                             "ann_file": str(tmp_path / "missing.json"),
                             "det_file": str(tmp_path / "missing_dets.json")}}
    cfg = t_config.load_config(None, {**_overrides(
        checkpoint_dir=str(tmp_path / "x")), **override})
    roidb = synthetic_roidb(**DATA)
    if "data" in override:
        with pytest.raises(FileNotFoundError, match="missing.json"):
            t_train._datasets(cfg)
        state = t_train.train(cfg, roidb, max_steps=1, device="cpu",
                              profile_dir=str(tmp_path / "p"))
        assert state.step == 1
        return
    local = t_train.train(t_config.load_config(None, _overrides(
        checkpoint_dir=str(tmp_path / "local"))), roidb, max_steps=2,
        device="cpu")
    try:
        state = t_train.train(cfg, roidb, max_steps=2, device="cpu",
                              profile_dir=str(tmp_path / "p"))
        assert torch.distributed.get_world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
    assert state.step == local.step == 2
    want = local.model.state_dict()
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6)


def test_default_eval_logs_val_ap_and_keeps_the_best_checkpoint(tmp_path):
    """``eval_every`` with a validation set and no ``eval_fn`` logs the
    COCO stats of the rescored detections and keeps the best checkpoint on
    ``val_AP``."""
    import json

    roidb = synthetic_roidb(**DATA)
    path = tmp_path / "m.jsonl"
    t_train.train(_loop_cfg(tmp_path, "v", eval_every=1), roidb,
                  val_roidb=roidb, max_steps=2, device="cpu",
                  metrics_path=str(path))
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    aps = [r["val_AP"] for r in recs if "val_AP" in r]
    assert len(aps) == 2 and all(0.0 <= ap <= 1.0 for ap in aps)
    best = json.loads((tmp_path / "v" / "best.json").read_text())
    assert best == {"metric": max(aps)}
    assert (tmp_path / "v" / "best" / "state.pt").exists()


def test_global_norm_and_clip_follow_optax(rng):
    """Clipping divides by the norm exactly (optax), not by norm + 1e-6
    (torch's clip_grad_norm_)."""
    g = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,))]
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(x) for x in g], optax.EmptyState())[0]
    _, tc = _configs(optimizer="sgd", learning_rate=1.0, grad_clip_norm=1.0)
    params = [torch.zeros(x.shape, requires_grad=True) for x in g]
    for p, x in zip(params, g):
        p.grad = torch.from_numpy(x)
    opt = t_train.OptaxOptimizer(params, tc)
    opt.param_groups[0]["lr"] = 1.0
    assert opt.step()
    for p, w in zip(params, want):       # p = -clipped g after one step
        np.testing.assert_allclose(-p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(t_train.global_norm([torch.from_numpy(x) for x in g])),
        float(optax.global_norm([jnp.asarray(x) for x in g])), rtol=1e-6)
