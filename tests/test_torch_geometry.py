"""ops/geometry.py of the port against gossipnet_tpu.ops.geometry: the same
operations in the same order, so IoU and IoF agree bit for bit, degenerate
and padded (all-zero) boxes included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.ops import geometry as jg
from gossipnet_tpu_torch.ops import geometry as tg
from tests.conftest import random_boxes


def _boxes(rng, n):
    boxes = random_boxes(rng, n)
    boxes[::7] = 0.0                                  # padding rows
    boxes[3::11, 2] = boxes[3::11, 0]                 # zero-width boxes
    boxes[5::13, 2:] = boxes[5::13, :2] - 1.0         # inverted boxes
    boxes[1] = boxes[2]                               # an exact duplicate
    return boxes


@pytest.mark.parametrize("fn", ["pairwise_iou", "pairwise_iof"])
def test_pairwise_overlaps_bit_exact(rng, fn):
    a, b = _boxes(rng, 37), _boxes(rng, 23)
    want = np.asarray(getattr(jg, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tg, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[::7] == 0).all()
    # batched leading dimensions give the per-image matrices
    batched = getattr(tg, fn)(torch.from_numpy(np.stack([a, a[::-1]])),
                              torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[0].numpy(), want)


def test_area_and_format_helpers_bit_exact(rng):
    boxes = _boxes(rng, 40)
    t = torch.from_numpy(boxes)
    np.testing.assert_array_equal(tg.box_area(t).numpy(),
                                  np.asarray(jg.box_area(jnp.asarray(boxes))))
    for name in ("xywh_to_xyxy", "xyxy_to_xywh"):
        np.testing.assert_array_equal(
            getattr(tg, name)(t).numpy(),
            np.asarray(getattr(jg, name)(jnp.asarray(boxes))))
    for got, want in zip(tg.box_center_size(t),
                         jg.box_center_size(jnp.asarray(boxes))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
