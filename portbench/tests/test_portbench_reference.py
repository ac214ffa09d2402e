"""The reference agrees with the port's plain path at a small size on the
CPU, before the card is ever asked; its control does not."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import gossipnet as ref
from portbench.reference import training as ref_train
from portbench.traffic import drill

MODEL = {"num_blocks": 2, "feature_dim": 128, "reduced_dim": 32,
         "pairwise_dim": 32}


def program(model_tree, **extra):
    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.train import build_model

    cfg = load_config(None, overrides={"model": {**model_tree, **extra}})
    return cfg, build_model(cfg, "kernel", "cpu")


def test_forward_agrees_with_the_port():
    w = weights.make(MODEL, 2 ** 35 + 3, "cpu")
    _, net = program(MODEL)
    net.load_state_dict(w)
    _, ctl = program(MODEL, pair_elementwise_dtype="bfloat16")
    ctl.load_state_dict(w)
    worst = control = 0.0
    for im in drill.draw(4, "ref", "full", 4, 1024):
        bx, sc = torch.tensor(im.boxes), torch.tensor(im.scores)
        valid = torch.ones(1, len(sc), dtype=torch.bool)
        with torch.no_grad():
            want = torch.sigmoid(ref.forward(w, ref.Geometry(bx, sc), 2))
            got = torch.sigmoid(net(bx[None], sc[None], valid)[0])
            low = torch.sigmoid(ctl(bx[None], sc[None], valid)[0])
        worst = max(worst, float((got - want).abs().max()))
        control = max(control, float((low - want).abs().max()))
    assert worst < 1e-6
    assert control > 100 * max(worst, 1e-7)


def test_weights_from_the_seed():
    a = weights.make(MODEL, 7, "cpu")
    b = weights.make(MODEL, 7, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], weights.make(MODEL, 8, "cpu")
                           ["head.weight"])
    _, net = program(MODEL)
    assert set(a) == set(net.state_dict())
    assert weights.parameter_count(MODEL) == sum(
        p.numel() for p in net.parameters())


def test_matching_agrees_with_the_port():
    from gossipnet_tpu_torch.ops.matching import greedy_match_batch

    for im in drill.draw(6, "match", "dense_p", 2, 1024):
        rng = np.random.default_rng(1)
        logits = rng.normal(size=len(im.scores)).astype(np.float32)
        crowd = im.gt_crowd.copy()
        crowd[:2] = True
        labels, ignore = ref_train.match(im.boxes, logits, im.gt_boxes,
                                         crowd, [0.5, 0.7])
        t = lambda x: torch.as_tensor(x)[None]
        got = greedy_match_batch(
            t(im.boxes), t(logits), t(np.ones(len(logits), bool)),
            t(im.gt_boxes), t(np.ones(len(crowd), bool)), t(crowd),
            [0.5, 0.7], impl="scan")
        np.testing.assert_array_equal(got.labels[0].numpy(), labels)
        np.testing.assert_array_equal(got.ignore[0].numpy(), ignore)


def test_step_agrees_with_the_port():
    """Step 1's loss and gradient of config 2 at two blocks, the port's
    plain path against the reference."""
    from gossipnet_tpu_torch.data.bucketing import make_batch
    from gossipnet_tpu_torch.data.roidb import ImageRecord
    from gossipnet_tpu_torch.train import batch_to_device, loss_and_metrics

    cfg, net = program(MODEL)
    w = weights.make(MODEL, 2 ** 34 + 1, "cpu")
    net.load_state_dict(w)
    ims = drill.draw(8, "step", "full", 4, 1024)
    recs = [ImageRecord(i, im.boxes, im.scores,
                        np.zeros(len(im.scores), np.int32), im.gt_boxes,
                        np.zeros(len(im.gt_boxes), np.int32), im.gt_crowd)
            for i, im in enumerate(ims)]
    batch = batch_to_device(make_batch(recs, 64), "cpu")
    loss, _ = loss_and_metrics(net, batch, cfg)
    loss.backward()
    want, grads = ref_train.loss_and_grads(
        w, [(im.boxes, im.scores, im.gt_boxes, im.gt_crowd) for im in ims],
        2, [0.5])
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    named = dict(net.named_parameters())
    for k, g in grads.items():
        # the port's backward rounds its pair dots' operands to bf16
        gap = float((named[k].grad - g).norm())
        assert gap <= 2e-2 * float(g.norm()) + 1e-7, k


def test_adam_is_optax_adam():
    p = {"x": torch.tensor([1.0, -2.0, 3.0])}
    adam = ref_train.Adam(p, lr=0.1, max_norm=0.0)
    g = {"x": torch.tensor([0.5, -0.25, 0.0])}
    new, used = adam.step(p, g)
    assert torch.equal(used["x"], g["x"])
    # step 1: mu_hat = g, nu_hat = g^2, update = g / (|g| + eps)
    want = p["x"] - 0.1 * g["x"] / (g["x"].abs() + 1e-8)
    assert torch.allclose(new["x"], want)
    clip = ref_train.Adam(p, lr=0.1, max_norm=0.1)
    _, used = clip.step(p, g)
    assert float(used["x"].norm()) == pytest.approx(0.1)
