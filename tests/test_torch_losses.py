"""losses.py of the port against gossipnet_tpu.losses: detection weights in
every mode and the weighted logistic loss per image and per batch, on the
same labels, to 1e-6."""

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu import losses as jl
from gossipnet_tpu.ops.matching import MatchResult as JMatch
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import losses as tl
from gossipnet_tpu_torch.ops.matching import MatchResult as TMatch

TOL = dict(rtol=1e-6, atol=1e-6)


def _labels(rng, b=3, t=2, n=40):
    labels = (rng.uniform(size=(b, t, n)) < 0.3).astype(np.float32)
    ignore = rng.uniform(size=(b, t, n)) < 0.2
    labels[0, 0] = 0.0                 # an image with no positive
    ignore[1, 1] = True                # one with everything ignored
    logits = rng.normal(0, 3, (b, n)).astype(np.float32)
    return labels, ignore, logits


@pytest.mark.parametrize("mode", ["balanced", "fixed", "none"])
def test_detection_weights(rng, mode):
    labels, ignore, _ = _labels(rng)
    kw = dict(pos_weight_mode=mode, fixed_pos_weight=2.5)
    want = jl.detection_weights(jnp.asarray(labels), jnp.asarray(ignore),
                                j_config.LossConfig(**kw))
    got = tl.detection_weights(torch.from_numpy(labels),
                               torch.from_numpy(ignore),
                               t_config.LossConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["balanced", "fixed", "none"])
@pytest.mark.parametrize("normalize", ["per_image", "per_batch"])
def test_weighted_logistic_loss(rng, normalize, mode):
    labels, ignore, logits = _labels(rng)
    kw = dict(normalize=normalize, pos_weight_mode=mode)
    mg = np.full(labels.shape, -1, np.int32)
    want_loss, want_m = jl.weighted_logistic_loss(
        jnp.asarray(logits), JMatch(jnp.asarray(labels), jnp.asarray(ignore),
                                    jnp.asarray(mg)),
        j_config.LossConfig(**kw))
    loss, m = tl.weighted_logistic_loss(
        torch.from_numpy(logits), TMatch(torch.from_numpy(labels),
                                         torch.from_numpy(ignore),
                                         torch.from_numpy(mg)),
        t_config.LossConfig(**kw))
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("loss", "pos_frac", "num_pos"):
        np.testing.assert_allclose(m[k].item(), float(want_m[k]), **TOL)


def test_unknown_modes_raise(rng):
    labels, ignore, logits = _labels(rng)
    match = TMatch(torch.from_numpy(labels), torch.from_numpy(ignore), None)
    with pytest.raises(ValueError, match="pos_weight_mode"):
        tl.detection_weights(match.labels, match.ignore,
                             t_config.LossConfig(pos_weight_mode="odd"))
    with pytest.raises(ValueError, match="normalize"):
        tl.weighted_logistic_loss(torch.from_numpy(logits), match,
                                  t_config.LossConfig(normalize="odd"))
