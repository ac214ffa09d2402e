"""K1 (pair-pool forward): the port's plain version against the JAX TPU
kernel run in interpret mode and against the JAX dense pair stage; the
tile flags; and the CUDA wrapper's refusal to fall back.

Tolerances, f32:
- against the JAX kernel (interpret mode): rtol = atol = 1e-5. Both fold
  the separable features in the same f32 arithmetic, so only summation
  order differs (measured max |diff| 7.6e-6 on outputs up to ~34).
- against the JAX dense path: rtol = 1e-5, atol = 5e-5. The dense path
  computes (cx_j - cx_i) / w_i where the fold computes
  cx_j * (1 / w_i) - cx_i / w_i; the cancellation costs a few f32 ulps of
  cx / w (measured max |diff| 1.07e-5 on an output of 0.05).
bf16: both sides round the same operands to bf16 and accumulate in f32,
so they differ by summation order, except where that order moves an h1
value across a bf16 rounding boundary: one bf16 ulp (2^-8 relative) of
h1 times a weight. So 99% of the outputs must agree to 1e-4 and all to
rtol = atol = 2e-2 (measured: 1 of 4096 outputs off, by 2.3e-3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.models.gossipnet import PairParams as JParams
from gossipnet_tpu.models.gossipnet import pair_pool_dense as j_dense
from gossipnet_tpu.ops import pair_features as j_pf
from gossipnet_tpu.ops.pallas.pairwise import _tile_activity as j_tiles
from gossipnet_tpu.ops.pallas.pairwise2 import (
    pallas_pair_pool_rect_v2,
    pallas_pair_pool_v2,
)
from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import pair_features as t_pf
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from tests.test_pallas_kernel import _problem

THR = 0.2
F32_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_TOL = dict(rtol=1e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.mean(np.abs(got - want) > 1e-4) < 0.01


def _case(rng, b=2, n=64, n_valid=None, num_classes=0, p=32):
    boxes, scores, valid, classes = _problem(rng, b=b, n=n, n_valid=n_valid,
                                             num_classes=num_classes)
    g = (j_pf.NUM_PAIR_FEATURES_MC if num_classes
         else j_pf.NUM_PAIR_FEATURES)
    w = {name: rng.normal(0, 0.5, shape).astype(np.float32) for name, shape
         in dict(wa=(p, p), wb=(p, p), wg=(g, p), b1=(p,), w2=(p, p),
                 b2=(p,)).items()}
    a = rng.normal(0, 1, (b, n, p)).astype(np.float32)
    bb = rng.normal(0, 1, (b, n, p)).astype(np.float32)
    cls = None if classes is None else np.array(classes)
    return (np.array(boxes), np.array(scores), np.array(valid), cls,
            a, bb, w)


def _jax_cols(boxes, scores, valid):
    return j_pf.det_columns(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(valid))


def _torch_cols(boxes, scores, valid):
    return t_pf.stack_columns(t_pf.det_columns(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid)))


def _port(boxes, scores, valid, cls, a, bb, w, dtype="float32", rows=None,
          **kw):
    cs = _torch_cols(boxes, scores, valid)
    row_cs, a_rows = cs, a
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows].contiguous(), a[:, rows]
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    tcls = None if cls is None else torch.from_numpy(cls)
    row_cls = None if tcls is None or rows is None else tcls[:, rows]
    m = k1.pair_pool(row_cs, cs, torch.from_numpy(np.ascontiguousarray(
        a_rows)), torch.from_numpy(bb), prm, THR,
        classes=row_cls if row_cls is not None else tcls,
        col_classes=tcls, compute_dtype=dtype, **kw)
    return m.numpy()


def _pallas(boxes, scores, valid, cls, a, bb, w, dtype="float32", rows=None):
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    prm = JParams(**{k: jnp.asarray(v) for k, v in w.items()})
    jcls = None if cls is None else jnp.asarray(cls)
    if rows is None:
        return np.asarray(pallas_pair_pool_v2(
            cs, jnp.asarray(a), jnp.asarray(bb), prm, THR, classes=jcls,
            interpret=True, compute_dtype=dtype))
    return np.asarray(pallas_pair_pool_rect_v2(
        cs[:, :, rows], cs, jnp.asarray(a[:, rows]), jnp.asarray(bb), prm,
        THR, row_classes=None if jcls is None else jcls[:, rows],
        col_classes=jcls, interpret=True, compute_dtype=dtype))


def _jax_dense(boxes, scores, valid, cls, a, bb, w):
    g, mask = j_pf.dense_pair_tensor(
        _jax_cols(boxes, scores, valid), THR,
        classes=None if cls is None else jnp.asarray(cls))
    return np.asarray(j_dense(jnp.asarray(a), jnp.asarray(bb),
                              jnp.asarray(w["wg"]), jnp.asarray(w["w2"]),
                              jnp.asarray(w["b2"]), g, mask))


CASES = {
    "odd_padded": dict(b=1, n=101, n_valid=67),
    "multiclass": dict(b=2, n=48, num_classes=4),
    "p16": dict(b=2, n=40, p=16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret_and_dense_f32(rng, name):
    case = _case(rng, **CASES[name])
    got = _port(*case)
    np.testing.assert_allclose(got, _pallas(*case), **F32_TOL)
    np.testing.assert_allclose(got, _jax_dense(*case), **DENSE_TOL)
    assert (got > 0).any()


def test_plain_matches_pallas_rectangular(rng):
    case = _case(rng, b=2, n=72, n_valid=60)
    rows = np.arange(9, 46)                       # NR = 37 != NC = 72
    got = _port(*case, rows=rows)
    assert got.shape == (2, 37, 32)
    np.testing.assert_allclose(got, _pallas(*case, rows=rows), **F32_TOL)
    np.testing.assert_allclose(got, _jax_dense(*case)[:, rows], **DENSE_TOL)


def test_plain_matches_pallas_rectangular_multiclass(rng):
    case = _case(rng, b=1, n=50, num_classes=3)
    rows = np.arange(3, 20)
    np.testing.assert_allclose(_port(*case, rows=rows),
                               _pallas(*case, rows=rows), **F32_TOL)


def test_plain_bf16_matches_pallas_interpret_bf16(rng):
    case = _case(rng, b=2, n=64, n_valid=50)
    got = _port(*case, dtype="bfloat16")
    _assert_bf16_close(got, _pallas(*case, dtype="bfloat16"))
    # and the rounding is really applied
    assert np.abs(got - _port(*case)).max() > 1e-3


def test_all_padding_image_pools_to_zero(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=2, n=40)
    valid[1] = False
    got = _port(boxes, scores, valid, cls, a, bb, w)
    assert (got[1] == 0).all()
    np.testing.assert_allclose(
        got, _pallas(boxes, scores, valid, cls, a, bb, w), **F32_TOL)


@pytest.mark.parametrize("block_sparse", [True, False])
def test_block_sparse_flag_is_exact(rng, block_sparse):
    """On CPU block_sparse changes nothing; the flags it would hand the
    kernel are conservative: every neighbour pair lies in an active tile."""
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=2, n=150, n_valid=140)
    # x-sorted, so tiles are narrow in x and some tile pairs cannot meet
    boxes = np.take_along_axis(
        boxes, np.argsort(boxes[..., 0], axis=1)[..., None], axis=1)
    got = _port(boxes, scores, valid, cls, a, bb, w,
                block_sparse=block_sparse)
    np.testing.assert_allclose(
        got, _jax_dense(boxes, scores, valid, cls, a, bb, w), **DENSE_TOL)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR, block_sparse=block_sparse)
    flags = geom.flags.numpy()
    assert flags.shape == (2, 5, 3)          # ceil(150/32), ceil(150/64)
    _, mask = j_pf.dense_pair_tensor(_jax_cols(boxes, scores, valid), THR)
    bi, i, j = np.nonzero(np.asarray(mask))
    assert flags[bi, i // k1.TILE_I, j // k1.TILE_J].all()
    if block_sparse:
        assert flags.mean() < 1.0            # something is skipped
    else:
        assert (flags == 1).all()


def test_tile_flags_match_jax_tile_activity(rng):
    boxes, scores, valid, *_ = _case(rng, b=2, n=128, n_valid=100)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR)
    jcs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    want = np.asarray(j_tiles(jnp.swapaxes(jcs, 1, 2), jcs, k1.TILE_I,
                              k1.TILE_J)).reshape(geom.flags.shape)
    np.testing.assert_array_equal(geom.flags.numpy(), want)


def test_zero_threshold_takes_no_tile_skip(rng):
    boxes, scores, valid, *_ = _case(rng, b=1, n=64)
    cs = _torch_cols(boxes, scores, valid)
    assert (k1.pair_geometry(cs, cs, 0.0).flags == 1).all()


def test_wrapper_never_falls_back_off_cpu(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    cs = _torch_cols(boxes, scores, valid)
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    before = k1.pair_pool.launches
    # A CUDA device with no card: raises, never a plain-version result.
    with pytest.raises((RuntimeError, AssertionError)):
        k1.pair_pool(cs.to("cuda"), cs.to("cuda"),
                     torch.from_numpy(a).to("cuda"),
                     torch.from_numpy(bb).to("cuda"), prm, THR)
    # Any other device is refused rather than computed on the CPU.
    meta = [t.to("meta") for t in (cs, torch.from_numpy(a),
                                   torch.from_numpy(bb))]
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        k1.pair_pool(meta[0], meta[0], meta[1], meta[2], prm, THR)
    # The kernel library itself refuses to load without a device.
    from gossipnet_tpu_torch.ops.cuda import build
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load("pairwise2_fwd")
    assert k1.pair_pool.launches == before


def test_bad_compute_dtype_raises(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    with pytest.raises(ValueError, match="compute_dtype"):
        _port(boxes, scores, valid, cls, a, bb, w, dtype="float16")
