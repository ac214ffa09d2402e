"""The two reduced-precision knobs of the port against the JAX package:
``pair_elementwise_dtype: bfloat16`` (K1/K2's bf16 stream of h1, pre2 and
the running max) and ``model.dtype: bfloat16`` (bf16 inputs, columns,
rank feature and class embedding, the dense layers in float32).

JAX runs on the CPU with the Pallas kernel in interpret mode; the port
runs its plain versions. XLA's excess-precision pass may elide a
f32->bf16->f32 rounding in interpret mode, so JAX is not held bit for bit.
Every tolerance is stated where it is used, and each test asserts that it
is tighter than the gap between JAX's own bf16 and float32 results on the
same inputs, so the test fails if the port ignores the knob.

- K1, bf16 stream: every port entry is a bf16 value; at most 1% of the
  entries differ from JAX, each by at most one bf16 ulp of JAX's value
  (measured: none differ). Gap: JAX's bf16 and f32 streams differ by more
  than one ulp in most entries.
- K2, bf16 stream: the bf16 gradient gate of tests/test_torch_pair_pool.py
  (d_a' 2e-2 with 99% within 1e-4; d_b' and dWg 2e-2, of the largest
  entry for dWg; dW2, db2 1e-4 of the largest entry; measured 1.8e-3 for
  d_b', 4.6e-3 for dWg, 1e-7 else). Gap: relative L2 0.07-0.17.
- The model with ``model.dtype: bfloat16``: logits rtol = atol = 1e-5
  (measured 6.6e-7; gap 5e-2 and more); one SGD step's update within
  1e-4 of each parameter's largest update (measured 2.7e-6), the class
  embedding's within one bf16 ulp of its largest, 2^-8 (its gradient is
  a sum of bf16 cotangents, which both packages round in their own order;
  measured 8.1e-4; gap 8e-2).
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu.models.gossipnet import PairParams as JParams
from gossipnet_tpu.ops import pair_features as j_pf
from gossipnet_tpu.ops.pallas.pairwise2 import pallas_pair_pool_v2
from gossipnet_tpu.utils.export import unflatten_paths
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch.models.gossipnet import GossipNet, PairParams
from gossipnet_tpu_torch.ops.cuda import launch
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import flatten_paths, params_from_jax, params_to_jax
from tests.test_pallas_kernel import _problem
from tests.test_torch_model import _random_tree
from tests.test_torch_pair_pool import (
    GRAD_FIELDS,
    THR,
    _assert_grads_close,
    _case,
    _jax_cols,
    _torch_cols,
)

KERNEL_CASES = {
    "agnostic": dict(b=2, n=64),
    "multiclass": dict(b=2, n=48, num_classes=4),
}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _is_bf16(x: np.ndarray) -> bool:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return bool(torch.equal(t.to(torch.bfloat16).float(), t))


def _pallas_m(case, ew):
    boxes, scores, valid, cls, a, bb, w = case
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    prm = JParams(**{k: jnp.asarray(v) for k, v in w.items()})
    return np.asarray(pallas_pair_pool_v2(
        cs, jnp.asarray(a), jnp.asarray(bb), prm, THR,
        classes=None if cls is None else jnp.asarray(cls), interpret=True,
        compute_dtype="bfloat16", elementwise_dtype=ew))


def _port_m(case, ew):
    boxes, scores, valid, cls, a, bb, w = case
    cs = _torch_cols(boxes, scores, valid)
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    return k1.pair_pool(cs, cs, torch.from_numpy(a), torch.from_numpy(bb),
                        prm, THR,
                        classes=None if cls is None else torch.from_numpy(cls),
                        compute_dtype="bfloat16",
                        elementwise_dtype=ew).numpy()


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_k1_bf16_stream_matches_pallas_interpret(rng, name):
    case = _case(rng, **KERNEL_CASES[name])
    got = _port_m(case, "bfloat16")
    want = _pallas_m(case, "bfloat16")
    assert got.dtype == np.float32 and _is_bf16(got)
    diff = np.abs(got - want)
    assert (diff <= _bf16_ulp(want)).all()
    assert np.mean(diff > 0) <= 0.01
    # the gap the tolerance must be tighter than: JAX's f32 stream
    gap = np.abs(want - _pallas_m(case, "float32"))
    assert np.mean(gap > _bf16_ulp(want)) > 0.01
    # and the port's own f32 stream differs from its bf16 one
    assert not np.array_equal(_port_m(case, "float32"), got)


def _grads(case, cot, ew, port):
    boxes, scores, valid, cls, a, bb, w = case
    if port:
        cs = _torch_cols(boxes, scores, valid)
        t = {"a": torch.from_numpy(a.copy()), "b": torch.from_numpy(bb.copy()),
             **{k: torch.from_numpy(v.copy()) for k, v in w.items()}}
        for k in GRAD_FIELDS:
            t[k].requires_grad_(True)
        prm = PairParams(t["wa"], t["wb"], t["wg"], t["b1"], t["w2"], t["b2"])
        m = k1.pair_pool(cs, cs, t["a"], t["b"], prm, THR,
                         classes=None if cls is None else torch.from_numpy(cls),
                         compute_dtype="bfloat16", elementwise_dtype=ew)
        (m * torch.from_numpy(cot)).sum().backward()
        return {k: t[k].grad.numpy() for k in GRAD_FIELDS}
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    jcls = None if cls is None else jnp.asarray(cls)

    def f(a_, b_, wg, w2, b2):
        prm = JParams(jnp.asarray(w["wa"]), jnp.asarray(w["wb"]), wg,
                      jnp.asarray(w["b1"]), w2, b2)
        m = pallas_pair_pool_v2(cs, a_, b_, prm, THR, classes=jcls,
                                interpret=True, compute_dtype="bfloat16",
                                elementwise_dtype=ew)
        return jnp.sum(m * jnp.asarray(cot))

    g = jax.grad(f, argnums=tuple(range(5)))(
        jnp.asarray(a), jnp.asarray(bb), jnp.asarray(w["wg"]),
        jnp.asarray(w["w2"]), jnp.asarray(w["b2"]))
    return {k: np.asarray(x) for k, x in zip(GRAD_FIELDS, g)}


def test_k2_bf16_stream_gradients_match_jax_grad(rng):
    case = _case(rng, **KERNEL_CASES["multiclass"])
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _grads(case, cot, "bfloat16", port=True)
    want = _grads(case, cot, "bfloat16", port=False)
    _assert_grads_close(got, want, bf16=True)
    # the gap: JAX's f32-stream gradients, relative L2, against the
    # loosest tolerance above (2e-2)
    f32 = _grads(case, cot, "float32", port=False)
    for k in GRAD_FIELDS:
        gap = np.linalg.norm(want[k] - f32[k]) / np.linalg.norm(want[k])
        assert gap > 2e-2, (k, gap)
        assert np.abs(got[k]).max() > 0, k


# ---------------------------------------------------------------------------
# model.dtype: bfloat16
# ---------------------------------------------------------------------------

LR = 0.1
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = 1e-4           # of each parameter's largest update
EMBED_TOL = 2.0 ** -8     # one bf16 ulp of the embedding's largest update


def _model_case(rng, num_classes):
    boxes, scores, valid, classes = _problem(
        rng, b=2, n=64, num_classes=num_classes if num_classes > 1 else 0)
    boxes, scores, valid = (np.array(x) for x in (boxes, scores, valid))
    valid[1, 50:] = False
    cls = None if classes is None else np.array(classes)
    cot = rng.normal(0, 1, scores.shape).astype(np.float32)
    return boxes, scores, valid, cls, cot


def _jax_step(cfg_kw, flat, pool_impl, data, step=True):
    """JAX logits and one SGD step's parameters (p - LR * grad), jitted as
    the reference trains; ``step=False``: the logits alone."""
    boxes, scores, valid, cls, cot = data
    model = JGossipNet(j_config.ModelConfig(**cfg_kw),
                       pool_impl="dense" if pool_impl == "dense" else "pallas")
    params = jax.tree.map(jnp.asarray, unflatten_paths(flat))
    args = [jnp.asarray(x) for x in (boxes, scores, valid)]
    if cls is not None:
        args.append(jnp.asarray(cls))

    def loss(p):
        logits = model.apply({"params": p}, *args)
        return jnp.sum(jnp.where(args[2], logits * cot, 0.0)), logits

    if not step:
        return np.asarray(jax.jit(lambda p: loss(p)[1])(params)), None
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    new = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    return np.asarray(logits), flatten_paths(jax.tree.map(np.asarray, new))


def _port_step(cfg_kw, flat, pool_impl, data):
    boxes, scores, valid, cls, cot = data
    model = GossipNet(t_config.ModelConfig(**cfg_kw), pool_impl=pool_impl,
                      device="cpu")
    model.load_state_dict(params_from_jax(flat))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    args = [torch.from_numpy(x) for x in (boxes, scores, valid)]
    if cls is not None:
        args.append(torch.from_numpy(cls))
    logits = model(*args)
    torch.where(args[2], logits * torch.from_numpy(cot), 0.0).sum().backward()
    opt.step()
    return (logits.detach().numpy(),
            flatten_paths(params_to_jax(model.state_dict())))


@pytest.mark.parametrize("num_classes", [1, 8])
@pytest.mark.parametrize("pool_impl", ["dense", "kernel"])
def test_bf16_model_forward_and_sgd_step_match_jax(rng, pool_impl,
                                                   num_classes):
    """The flagship's widths (128/32/32) at 2 blocks. The kernel path runs
    pair_matmul_dtype float32, so that only model.dtype separates the
    packages' bf16 and f32 runs."""
    data = _model_case(rng, num_classes)
    valid = data[2]
    cfg_kw = dict(num_blocks=2, feature_dim=128, reduced_dim=32,
                  pairwise_dim=32, num_classes=num_classes,
                  dtype="bfloat16", pair_matmul_dtype="float32")
    flat = _random_tree(t_config.ModelConfig(**cfg_kw), seed=3)
    logits, new = _port_step(cfg_kw, flat, pool_impl, data)
    j_logits, j_new = _jax_step(cfg_kw, flat, pool_impl, data)
    np.testing.assert_allclose(logits[valid], j_logits[valid], **LOGIT_TOL)
    f32_logits, f32_new = _jax_step({**cfg_kw, "dtype": "float32"}, flat,
                                    pool_impl, data, step=num_classes > 1)
    gap = np.abs(j_logits - f32_logits)[valid].max()
    assert gap > 100 * LOGIT_TOL["atol"], gap
    for k, want in j_new.items():
        upd, j_upd = new[k] - flat[k], want - flat[k]
        tol = EMBED_TOL if k == "class_embed/embedding" else STEP_TOL
        scale = np.abs(j_upd).max()
        assert np.abs(upd - j_upd).max() <= tol * scale, k
    if num_classes > 1:
        k = "class_embed/embedding"
        j_upd = j_new[k] - flat[k]
        gap = np.abs(j_upd - (f32_new[k] - flat[k])).max()
        assert gap > EMBED_TOL * np.abs(j_upd).max(), gap


# ---------------------------------------------------------------------------
# config, the paths that ignore the stream, the refusal
# ---------------------------------------------------------------------------


def test_knobs_load_from_yaml_and_overrides_like_jax(tmp_path):
    path = tmp_path / "bf16.yaml"
    path.write_text("model:\n  dtype: bfloat16\n"
                    "  pair_elementwise_dtype: bfloat16\n")
    over = {"model": {"dtype": "bfloat16",
                      "pair_elementwise_dtype": "bfloat16"}}
    for args in ((str(path), None), (None, over)):
        tc = t_config.load_config(*args)
        jc = j_config.load_config(*args)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.model.dtype == "bfloat16"
        assert tc.model.pair_elementwise_dtype == "bfloat16"
    bad = {"model": {"pair_matmul_dtype": "float32",
                     "pair_elementwise_dtype": "bfloat16"}}
    for cfg_mod in (t_config, j_config):
        with pytest.raises(ValueError, match="requires"):
            cfg_mod.load_config(None, bad)


@pytest.mark.parametrize("pool_impl,kernel", [("dense", 2), ("kernel", 1)])
def test_stream_knob_is_ignored_by_dense_and_pair_kernel_1(rng, pool_impl,
                                                           kernel):
    """As in JAX: the dense path and the v1 kernel (K5/K6) ignore
    pair_elementwise_dtype, so the logits are bit-equal to the f32
    stream's; the JAX dense path likewise."""
    boxes, scores, valid, _ = _problem(rng, b=2, n=40)
    args = [np.array(x) for x in (boxes, scores, valid)]
    out = {}
    for ew in ("float32", "bfloat16"):
        kw = dict(num_blocks=2, feature_dim=16, reduced_dim=8,
                  pairwise_dim=8, pair_kernel=kernel,
                  pair_elementwise_dtype=ew)
        flat = _random_tree(t_config.ModelConfig(**kw), seed=5)
        model = GossipNet(t_config.ModelConfig(**kw), pool_impl=pool_impl,
                          device="cpu")
        model.load_state_dict(params_from_jax(flat))
        with torch.inference_mode():
            out[ew] = model(*map(torch.from_numpy, args)).numpy()
        if pool_impl == "dense":
            jm = JGossipNet(j_config.ModelConfig(**kw), pool_impl="dense")
            out["jax", ew] = np.asarray(jax.jit(jm.apply)(
                {"params": jax.tree.map(jnp.asarray, unflatten_paths(flat))},
                *map(jnp.asarray, args)))
    assert np.array_equal(out["float32"], out["bfloat16"])
    if pool_impl == "dense":
        assert np.array_equal(out["jax", "float32"], out["jax", "bfloat16"])


def test_bf16_stream_with_f32_operands_is_refused(rng):
    """The reference's refusal (``pairwise2.py:933-937``) in the input
    check of every K1/K2 launch and in the wrapper, before any device
    check."""
    msg = "elementwise_dtype=bfloat16 requires compute_dtype=bfloat16"
    case = _case(rng, b=1, n=16)
    boxes, scores, valid, _, a, bb, w = case
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR)
    a2, b2 = (torch.from_numpy(x) for x in (a, bb))
    wg = torch.zeros(3, a.shape[-1])
    w2, bias = torch.zeros(a.shape[-1], a.shape[-1]), torch.zeros(a.shape[-1])
    with pytest.raises(ValueError, match=msg):
        launch.check_inputs("K1", geom, a2, b2, wg, w2, bias, "float32",
                            k1._LAYOUTS, elementwise_dtype="bfloat16")
    with pytest.raises(ValueError, match=msg):
        k1.launch_kernel(geom, a2, b2, wg, w2, bias, "float32", "bfloat16")
    with pytest.raises(ValueError, match=msg):
        k1.pair_pool(cs, cs, a2, b2,
                     PairParams(**{k: torch.from_numpy(v)
                                   for k, v in w.items()}),
                     THR, compute_dtype="float32",
                     elementwise_dtype="bfloat16")
    with pytest.raises(ValueError, match="elementwise_dtype must be"):
        launch.check_dtype("bfloat16", "float16")
    assert [launch.kernel_mode(*m) for m in (
        ("float32", "float32"), ("bfloat16", "float32"),
        ("bfloat16", "bfloat16"))] == [0, 1, 2]


def test_bf16_stream_launches_its_own_instantiation(rng, monkeypatch):
    """K1 and K2 hand their C entries mode 2 for the bf16 stream and count
    those launches apart (with the launch replaced: no card here)."""
    seen = []

    def fake_launch(name, label, entry, tiles, geom_, tensors, p, k,
                    splits, mode):
        seen.append((label, mode))

    monkeypatch.setattr(launch, "_launch", fake_launch)
    monkeypatch.setattr(launch, "_splits", lambda geom_, device, **kw: 1)
    monkeypatch.setattr(launch, "check_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(k1, "check_inputs", lambda *a, **kw: None)
    boxes, scores, valid, _, a, bb, _ = _case(rng, b=1, n=16, p=8)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR)
    # the neighbour list a CPU geometry lacks: the list kernel's twin
    geom = geom._replace(pairs=k1.pair_list_reference(geom))
    t = (torch.from_numpy(a), torch.from_numpy(bb), torch.zeros(3, 8),
         torch.zeros(8, 8), torch.zeros(8))
    before = (k1.pair_pool.launches, k1.pair_pool.launches_ew,
              k1.pair_pool_backward.launches,
              k1.pair_pool_backward.launches_ew)
    k1.launch_kernel(geom, *t, "bfloat16", "bfloat16")
    k1.launch_kernel(geom, *t, "bfloat16")
    m = torch.zeros(1, 16, 8)
    k1.launch_backward_kernel(geom, *t, m, m, "bfloat16", "bfloat16")
    assert seen == [("K1", 2), ("K1", 1), ("K2", 2)]
    after = (k1.pair_pool.launches, k1.pair_pool.launches_ew,
             k1.pair_pool_backward.launches,
             k1.pair_pool_backward.launches_ew)
    assert np.subtract(after, before).tolist() == [2, 1, 1, 1]


def test_artifact_serves_with_the_knobs_it_was_exported_with(rng, tmp_path):
    """An artifact carries its config: exported with both knobs, it serves
    what the live Rescorer serves with them (the same batches, bit for
    bit), and not what the defaults serve."""
    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.data.synthetic import synthetic_record
    from gossipnet_tpu_torch.params import init_params
    from gossipnet_tpu_torch.utils import model_artifact as ma

    over = {"model": {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
                      "pairwise_dim": 8, "dtype": "bfloat16",
                      "pair_elementwise_dtype": "bfloat16"},
            "data": {"bucket_sizes": [64]}, "train": {"batch_size": 2}}
    cfg = t_config.load_config(None, over)
    params = init_params(cfg.model, seed=1)
    path = tmp_path / "bf16.gnetart"
    ma.export_artifact(cfg, params, path, batch_sizes=(2,))
    art = ma.ArtifactRescorer(path, device="cpu")
    assert art.cfg.model == cfg.model
    images = []
    for i in range(2):
        rec = synthetic_record(rng, i, num_gt=4, dets_per_gt=3,
                               num_clutter=4)
        images.append((rec.det_boxes, rec.det_scores, None))
    got = art.rescore_batch(images, batch_size=2)
    live = Rescorer(cfg, params, pool_impl="kernel", device="cpu")
    for g, w in zip(got, live.rescore_batch(images, batch_size=2)):
        assert np.array_equal(g, w)
    plain_cfg = t_config.load_config(None, {**over, "model": {
        **over["model"], "dtype": "float32",
        "pair_elementwise_dtype": "float32"}})
    plain = Rescorer(plain_cfg, params, pool_impl="kernel", device="cpu")
    assert not all(np.array_equal(g, w) for g, w in zip(
        got, plain.rescore_batch(images, batch_size=2)))
