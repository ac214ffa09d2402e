"""K1's CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol = atol = 1e-5 (the kernel and the plain version do
the same f32 arithmetic in another summation order); bf16 as in
tests/test_torch_pair_pool.py (one bf16 ulp of an h1 value may flip):
rtol = atol = 2e-2 everywhere and 1e-4 on 99% of the outputs. Neighbour
masks are exact by construction (explicitly rounded IoU).
"""

import numpy as np
import pytest
import torch

from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1

THR = 0.2


def _clustered(rng, b, n, n_valid=None, num_classes=0, canvas=300.0):
    centers = rng.uniform(0, canvas, (max(n // 6, 1), 2))
    size = rng.uniform(20, 60, (len(centers), 2))
    idx = rng.integers(0, len(centers), (b, n))
    xy = centers[idx] + rng.normal(0, 6.0, (b, n, 2))
    wh = np.maximum(size[idx] + rng.normal(0, 6.0, (b, n, 2)), 1.0)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    if n_valid is not None:
        valid[:, n_valid:] = False
    classes = (rng.integers(0, num_classes, (b, n)) if num_classes else None)
    return boxes, scores, valid, classes


CASES = {
    "odd_padded": dict(b=2, n=301, n_valid=270),
    "rect": dict(b=2, n=200, rows=slice(7, 130)),
    "multiclass": dict(b=2, n=256, num_classes=5),
    "dense_tiles": dict(b=1, n=300, block_sparse=False),
    "p16": dict(b=2, n=150, p=16),
    "p64": dict(b=1, n=150, p=64),
    "all_padding": dict(b=2, n=128, all_invalid=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    case = dict(CASES[name])
    p = case.pop("p", 32)
    rows = case.pop("rows", slice(None))
    block_sparse = case.pop("block_sparse", True)
    all_invalid = case.pop("all_invalid", None)
    rng = np.random.default_rng(len(name))
    boxes, scores, valid, classes = _clustered(rng, **case)
    if all_invalid is not None:
        valid[all_invalid] = False
    dev = torch.device("cuda")
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    b, n = scores.shape
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    prm = PairParams(*[torch.from_numpy(
        rng.normal(0, 0.5, s).astype(np.float32)).to(dev)
        for s in ((p, p), (p, p), (g, p), (p,), (p, p), (p,))])
    a = torch.from_numpy(rng.normal(0, 1, (b, n, p)).astype(
        np.float32)).to(dev)
    bb = torch.from_numpy(rng.normal(0, 1, (b, n, p)).astype(
        np.float32)).to(dev)
    cls = None if classes is None else torch.from_numpy(classes).to(dev)
    kw = dict(classes=None if cls is None else cls[:, rows].contiguous(),
              col_classes=cls, compute_dtype=dtype)
    row_cs = cs[:, :, rows].contiguous()
    a_rows = a[:, rows].contiguous()
    before = k1.pair_pool.launches
    got = k1.pair_pool(row_cs, cs, a_rows, bb, prm, THR,
                       block_sparse=block_sparse, **kw)
    want = k1.pair_pool_reference(row_cs, cs, a_rows, bb, prm, THR, **kw)
    torch.cuda.synchronize()
    assert k1.pair_pool.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert (want > 0).any() or all_invalid is not None
    if all_invalid is not None:
        assert (got[all_invalid] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(got - want) > 1e-4) < 0.01
