"""PyTorch port vs JAX reference: pair features, score rank, Morton key.

Inputs are made with numpy from a seed and handed to both sides; JAX runs
on the CPU as conftest.py sets it up.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.ops import order as j_order
from gossipnet_tpu.ops import pair_features as j_pf
from gossipnet_tpu.ops import ranking as j_ranking
from gossipnet_tpu_torch.ops import order as t_order
from gossipnet_tpu_torch.ops import pair_features as t_pf
from gossipnet_tpu_torch.ops import ranking as t_ranking
from tests.conftest import random_boxes


def _boxes(rng, b=2, n=48, degenerate=True):
    boxes = np.stack([random_boxes(rng, n, scale=120.0) for _ in range(b)])
    if degenerate:
        # zero-width, zero-height, inverted and point boxes: the
        # _MIN_SIZE clamp of det_columns
        boxes[:, 0, 2] = boxes[:, 0, 0]
        boxes[:, 1, 3] = boxes[:, 1, 1]
        boxes[:, 2, 2:] = boxes[:, 2, :2] - 3.0
        boxes[:, 3, 2:] = boxes[:, 3, :2]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[1, n - 7:] = False
    return boxes.astype(np.float32), scores, valid


def test_det_columns_match_jax_with_degenerate_boxes(rng):
    boxes, scores, valid = _boxes(rng)
    jc = j_pf.det_columns(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(valid))
    tc = t_pf.det_columns(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid))
    for name in t_pf.DetColumns._fields:
        got = getattr(tc, name).numpy()
        want = np.asarray(getattr(jc, name))
        if name.startswith("log"):
            # XLA's and PyTorch's f32 log may differ in the last ulp.
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tc.w.numpy()[:, :4] >= t_pf._MIN_SIZE).all()


def test_dense_pair_tensor_matches_jax(rng):
    boxes, scores, valid = _boxes(rng, n=40)
    jc = j_pf.det_columns(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(valid))
    tc = t_pf.det_columns(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid))
    jg, jm = j_pf.dense_pair_tensor(jc, 0.2)
    tg, tm = t_pf.dense_pair_tensor(tc, 0.2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.numpy().sum() > boxes.shape[0] * boxes.shape[1] // 2
    # log features may differ by an ulp of log (see above); the rest is
    # the same f32 arithmetic.
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-5)
    assert tg.shape[-1] == t_pf.NUM_PAIR_FEATURES


def test_score_rank_matches_jax_with_ties_and_padding(rng):
    scores = rng.choice([0.1, 0.5, 0.5, 0.7, 0.9], size=(3, 33)).astype(
        np.float32)
    valid = rng.uniform(size=(3, 33)) > 0.3
    valid[2] = False   # an all-padding image
    want = j_ranking.score_rank(jnp.asarray(scores), jnp.asarray(valid))
    got = t_ranking.score_rank(torch.from_numpy(scores),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("case", ["random", "corner", "all_invalid"])
def test_morton_key_bit_identical(rng, case):
    boxes, _, valid = _boxes(rng, b=2, n=64, degenerate=False)
    if case == "corner":
        # The max-corner box must hit the 65534 cap, below the sentinel.
        boxes[:, 5] = np.tile(boxes[:, :, :2].max(axis=1), (1, 2)) + 50.0
    if case == "all_invalid":
        valid[0] = False
    want = np.asarray(j_order.morton_sort_key(jnp.asarray(boxes),
                                              jnp.asarray(valid)))
    got = t_order.morton_sort_key(torch.from_numpy(boxes),
                                  torch.from_numpy(valid)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got[~valid] == 0xFFFFFFFF).all()
    assert (got[valid] < 0xFFFFFFFF).all()
    if case == "corner":
        assert (got[:, 5] == 0xFFFFFFFF - 3).all()   # both halves 65534
