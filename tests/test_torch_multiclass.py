"""The multi-class model (config 3: num_classes > 1) of the port against
the JAX one: the per-class score rank, the 80-class model through the
weights bridge on the dense path and on both pair kernels (K1/K2 with the
class-match feature, K5/K6 with nine features), a class-aware training
step, and the Rescorer and JSON-lines server with class ids.

Tolerances: the score rank is computed from sorts and counts, so it is
exact. Logits at rtol = atol = 1e-4, as tests/test_torch_model.py holds
the class-agnostic model; training steps at 1e-5, as
tests/test_torch_train.py holds them (both sides IEEE f32, summation order
differs); served probabilities at atol = 1e-5.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu import train as j_train
from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu.ops.ranking import score_rank as j_score_rank
from gossipnet_tpu.serving import serve_stream as j_serve_stream
from gossipnet_tpu.utils.export import unflatten_paths
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.models.gossipnet import PAD_LOGIT, GossipNet
from gossipnet_tpu_torch.ops.ranking import score_rank
from gossipnet_tpu_torch.params import (
    flatten_paths,
    init_params,
    params_from_jax,
    params_to_jax,
)
from gossipnet_tpu_torch.serving import serve_stream
from tests.conftest import random_boxes
from tests.test_pallas_kernel import _problem
from tests.test_torch_model import _random_tree

NUM_CLASSES = 80
MODEL = dict(num_blocks=2, feature_dim=32, reduced_dim=16, pairwise_dim=16,
             num_classes=NUM_CLASSES, class_embed_dim=8,
             pair_matmul_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the per-class score rank
# ---------------------------------------------------------------------------

RANK_CASES = {
    "ties_and_padding": dict(shape=(3, 50), classes=4, grid=8, n_valid=41),
    "coco_classes": dict(shape=(2, 300), classes=80, grid=0, n_valid=260),
    "one_class": dict(shape=(2, 33), classes=1, grid=4, n_valid=None),
    "all_padding_row": dict(shape=(2, 20), classes=3, grid=5, n_valid=0),
    "batch_dims": dict(shape=(2, 2, 24), classes=5, grid=6, n_valid=20),
}


@pytest.mark.parametrize("name", sorted(RANK_CASES))
def test_per_class_score_rank_equals_jax_exactly(rng, name):
    case = RANK_CASES[name]
    shape = case["shape"]
    scores = rng.uniform(0, 1, shape).astype(np.float32)
    if case["grid"]:
        scores = np.round(scores * case["grid"]) / case["grid"]  # exact ties
    valid = np.ones(shape, bool)
    if case["n_valid"] is not None:
        valid[..., case["n_valid"]:] = False
    classes = rng.integers(0, case["classes"], shape).astype(np.int32)
    j_rank = jax.jit(j_score_rank, static_argnums=3)
    want = np.asarray(j_rank(jnp.asarray(scores), jnp.asarray(valid),
                             jnp.asarray(classes), case["classes"]))
    got = score_rank(torch.from_numpy(scores), torch.from_numpy(valid),
                     torch.from_numpy(classes), case["classes"]).numpy()
    np.testing.assert_array_equal(got, want)
    agnostic = score_rank(torch.from_numpy(scores), torch.from_numpy(valid))
    np.testing.assert_array_equal(agnostic.numpy(), np.asarray(j_rank(
        jnp.asarray(scores), jnp.asarray(valid), None, 1)))


# ---------------------------------------------------------------------------
# the 80-class model
# ---------------------------------------------------------------------------


def _detections(rng, b=2, n=70):
    boxes, scores, valid, classes = _problem(rng, b=b, n=n,
                                             num_classes=NUM_CLASSES)
    boxes, scores, valid, classes = (np.array(x) for x in
                                     (boxes, scores, valid, classes))
    valid[1, 55:] = False
    valid[0, ::9] = False          # padding rows inside the image too
    classes[:, ::3] = classes[:, :1]   # a class with many members
    return boxes, scores, valid, classes.astype(np.int32)


@pytest.mark.parametrize("pool_impl,pair_kernel", [
    ("dense", 2), ("kernel", 2), ("kernel", 1)])
def test_80_class_model_matches_jax(rng, pool_impl, pair_kernel):
    cfg_kw = dict(MODEL, pair_kernel=pair_kernel)
    cfg = t_config.ModelConfig(**cfg_kw)
    boxes, scores, valid, classes = _detections(rng)
    flat = _random_tree(cfg, seed=5)
    assert flat["class_embed/embedding"].shape == (NUM_CLASSES, 8)
    assert flat["block_0/pair_wg"].shape == (9, 16)
    params = jax.tree.map(jnp.asarray, unflatten_paths(flat))
    jmodel = JGossipNet(j_config.ModelConfig(**cfg_kw),
                        pool_impl="dense" if pool_impl == "dense"
                        else "pallas")
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(boxes), jnp.asarray(scores),
        jnp.asarray(valid), jnp.asarray(classes)))
    model = GossipNet(cfg, pool_impl=pool_impl, device="cpu")
    model.load_state_dict(params_from_jax(flat))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in
                      (boxes, scores, valid, classes))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[~valid] == PAD_LOGIT).all()
    assert np.isfinite(got).all() and np.std(got[valid]) > 1e-3


def test_classes_change_the_logits_and_are_required(rng):
    cfg = t_config.ModelConfig(**MODEL)
    boxes, scores, valid, classes = _detections(rng)
    model = GossipNet(cfg, pool_impl="kernel", device="cpu")
    model.load_state_dict(params_from_jax(_random_tree(cfg, seed=6)))
    t = [torch.from_numpy(x) for x in (boxes, scores, valid)]
    with torch.inference_mode():
        a = model(*t, torch.from_numpy(classes))
        b = model(*t, torch.from_numpy((classes + 1) % NUM_CLASSES))
    assert (a - b).abs().max() > 1e-3
    with pytest.raises(ValueError, match="requires `classes`"):
        model(*t)


def test_init_params_tree_matches_the_flax_tree():
    cfg_kw = dict(MODEL)
    jmodel = JGossipNet(j_config.ModelConfig(**cfg_kw), pool_impl="dense")
    want = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 8, 4)),
        jnp.zeros((1, 8)), jnp.ones((1, 8), bool),
        jnp.zeros((1, 8), jnp.int32))["params"])
    got = init_params(t_config.ModelConfig(**cfg_kw))
    assert jax.tree.map(np.shape, got) == want
    model = GossipNet(t_config.ModelConfig(**cfg_kw), device="cpu")
    sd = params_from_jax(got)
    model.load_state_dict(sd)
    assert sorted(flatten_paths(params_to_jax(model.state_dict()))) == \
        sorted(flatten_paths(got))


# ---------------------------------------------------------------------------
# a class-aware training step
# ---------------------------------------------------------------------------

DATA = dict(num_images=4, seed=0, num_gt=5, dets_per_gt=5, num_clutter=6,
            num_classes=NUM_CLASSES)


@pytest.mark.parametrize("pair_kernel", [2, 1])
def test_class_aware_sgd_steps_match_jax(pair_kernel):
    ov = {"model": dict(MODEL, pair_kernel=pair_kernel),
          "matching": {"class_aware": True},
          "data": {"bucket_sizes": [32, 64]},
          "parallel": {"enable": "off"},
          "train": {"batch_size": 2, "optimizer": "sgd",
                    "learning_rate": 0.05, "grad_clip_norm": 0.0}}
    jc, tc = j_config.load_config(None, ov), t_config.load_config(None, ov)
    flat = _random_tree(tc.model, seed=7)
    jstate = j_train.TrainState.create(
        apply_fn=JGossipNet(jc.model, pool_impl="dense").apply,
        params=jax.tree.map(jnp.asarray, unflatten_paths(flat)),
        tx=j_train.make_optimizer(jc), rng=jax.random.key(0))
    model = t_train.build_model(tc, "kernel", "cpu")
    state = t_train.create_train_state(tc, model, params=flat)
    it = BatchIterator(synthetic_roidb(**DATA), 2, (32, 64), seed=0)
    for _ in range(2):
        batch = next(it)
        assert len(np.unique(batch.classes[batch.valid])) > 3
        jstate, jm = j_train.train_step(
            jstate, {k: jnp.asarray(getattr(batch, k))
                     for k in t_train.BATCH_KEYS}, jc)
        state, tm = t_train.train_step(
            state, t_train.batch_to_device(batch, "cpu"), tc)
        for k in ("loss", "pos_frac", "num_pos", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **STEP_TOL, err_msg=k)
    want = flatten_paths(jax.tree.map(np.asarray, jstate.params))
    got = flatten_paths(params_to_jax(state.model.state_dict()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    # the class embedding trained too
    assert not np.allclose(got["class_embed/embedding"],
                           flat["class_embed/embedding"])


# ---------------------------------------------------------------------------
# serving with class ids
# ---------------------------------------------------------------------------

SERVE = {"model": dict(MODEL, num_blocks=2),
         "data": {"bucket_sizes": [32, 64]}}


@pytest.fixture(scope="module")
def rescorers():
    jcfg = j_config.load_config(None, SERVE)
    flat = _random_tree(t_config.load_config(None, SERVE).model, seed=8)
    params = unflatten_paths(flat)
    jr = JRescorer(jcfg, jax.tree.map(jnp.asarray, params),
                   pool_impl="dense", mesh=None)
    cfg = t_config.load_config(None, SERVE)
    ports = {pk: Rescorer(t_config.load_config(
        None, {**SERVE, "model": dict(SERVE["model"], pair_kernel=pk)}),
        params, pool_impl="kernel", device="cpu") for pk in (1, 2)}
    ports["dense"] = Rescorer(cfg, params, pool_impl="dense", device="cpu")
    return jr, ports


def _images(rng, sizes=(5, 20, 40, 64, 12)):
    out = []
    for n in sizes:
        boxes = random_boxes(rng, n, scale=60.0)
        out.append((boxes, rng.uniform(0, 1, n).astype(np.float32),
                    rng.integers(0, NUM_CLASSES, n).astype(np.int32)))
    return out


@pytest.mark.parametrize("impl", ["dense", 1, 2])
def test_rescorer_with_classes_matches_jax(rng, rescorers, impl):
    jr, ports = rescorers
    images = _images(rng)
    want = jr.rescore_batch(images, batch_size=2)
    got = ports[impl].rescore_batch(images, batch_size=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the classes are used: other ids give other scores
    other = [(b, s, (c + 7) % NUM_CLASSES) for b, s, c in images]
    moved = ports[impl].rescore_batch(other, batch_size=2)
    assert max(np.abs(g - m).max() for g, m in zip(got, moved)) > 1e-4


def test_serve_stream_with_classes_matches_jax(rng, rescorers):
    jr, ports = rescorers
    lines = []
    for k, (boxes, scores, classes) in enumerate(_images(rng, (4, 30, 50))):
        lines.append(json.dumps({"id": k, "boxes": boxes.tolist(),
                                 "scores": scores.tolist(),
                                 "classes": classes.tolist()}))
    lines.append(json.dumps({"id": "no_classes", "boxes": [[0, 0, 5, 5]],
                             "scores": [0.5]}))
    req = "\n".join(lines) + "\n"
    outs = []
    for r, fn in ((jr, j_serve_stream), (ports[1], serve_stream)):
        out = io.StringIO()
        n = fn(r, threshold=0.3, inp=io.StringIO(req), out=out)
        outs.append((n, [json.loads(x) for x in out.getvalue().splitlines()]))
    (jn, want), (n, got) = outs
    assert n == jn == 3 and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["id"] == w["id"]
        if "error" in w:
            assert g["error"] == w["error"]
        else:
            np.testing.assert_allclose(g["new_scores"], w["new_scores"],
                                       rtol=0, atol=2e-6)
            assert g["keep"] == w["keep"]


def test_rescorer_refuses_class_ids_outside_the_embedding(rng, rescorers):
    _, ports = rescorers
    boxes, scores, classes = _images(rng, (6,))[0]
    for bad in (NUM_CLASSES, -1):
        cl = classes.copy()
        cl[2] = bad
        with pytest.raises(ValueError, match="class ids"):
            ports[1].rescore_batch([(boxes, scores, cl)])
