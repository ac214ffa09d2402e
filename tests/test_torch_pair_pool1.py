"""K5 and K6 (the unfolded pair-pool forward and backward, ``pair_kernel:
1``): the port's plain versions against the JAX TPU kernel and its custom
VJP run in interpret mode and against the JAX dense pair stage; the tie
rule of the backward; K5 against K1, the same function; the tile flags
on K5's input layout; and the CUDA wrappers' refusal to fall back.

Tolerances, f32:
- against the JAX kernel (interpret mode): rtol = atol = 1e-5. Both
  compute the same IEEE f32 features and differ only in summation order
  (the TPU sums (a + b) + Wg.g as a dot, the port runs b + Wg.g as an fmaf
  chain, then + a).
- against the JAX dense path: rtol = 1e-5, atol = 5e-5, as for K1.
- K5 against K1 (plain versions): rtol = atol = 1e-5. K1 folds five
  features into a and b (``cx_j * (1 / w_i) - cx_i / w_i`` where K5
  divides the difference), which costs a few f32 ulps.
bf16: both sides round the features, Wg, h1 and W2 and accumulate in f32;
they differ by summation order, except where that order moves an h1 value
across a bf16 rounding boundary (one bf16 ulp, 2^-8 relative). So 99% of
the outputs must agree to 1e-4 and all to rtol = atol = 2e-2. Weight
gradients sum over every pair in another order: 1e-4 of their largest
entry in f32, 2e-2 of it in bf16.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.models.gossipnet import PairParams as JParams
from gossipnet_tpu.models.gossipnet import pair_pool_dense as j_dense
from gossipnet_tpu.ops import pair_features as j_pf
from gossipnet_tpu.ops.pallas.pairwise import (
    _tile_activity as j_tiles,
    pallas_pair_pool,
    pallas_pair_pool_rect,
)
from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops.cuda import pairwise as k5
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from tests.test_torch_pair_pool import (
    _assert_bf16_close,
    _case,
    _jax_cols,
    _torch_cols,
)

THR = 0.2
F32_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_TOL = dict(rtol=1e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_FIELDS = ("a", "b", "wg", "w2", "b2")


def _port(boxes, scores, valid, cls, a, bb, w, dtype="float32", rows=None,
          module=k5, **kw):
    cs = _torch_cols(boxes, scores, valid)
    row_cs, a_rows = cs, a
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows].contiguous(), a[:, rows]
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    tcls = None if cls is None else torch.from_numpy(cls)
    row_cls = tcls if tcls is None or rows is None else tcls[:, rows]
    m = module.pair_pool(row_cs, cs, torch.from_numpy(np.ascontiguousarray(
        a_rows)), torch.from_numpy(bb), prm, THR, classes=row_cls,
        col_classes=tcls, compute_dtype=dtype, **kw)
    return m.numpy()


@jax.jit
def _dense_jit(boxes, scores, valid, cls, a, bb, wg, w2, b2):
    g, mask = j_pf.dense_pair_tensor(_jax_cols(boxes, scores, valid), THR,
                                     classes=cls)
    return j_dense(a, bb, wg, w2, b2, g, mask)


def _jax_dense(boxes, scores, valid, cls, a, bb, w):
    """The JAX dense pair stage, compiled once per shape."""
    return np.asarray(_dense_jit(boxes, scores, valid, cls, a, bb, w["wg"],
                                 w["w2"], w["b2"]))


def _pallas(boxes, scores, valid, cls, a, bb, w, dtype="float32", rows=None):
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    prm = JParams(**{k: jnp.asarray(v) for k, v in w.items()})
    jcls = None if cls is None else jnp.asarray(cls)
    if rows is None:
        return np.asarray(pallas_pair_pool(
            cs, jnp.asarray(a), jnp.asarray(bb), prm, THR, classes=jcls,
            interpret=True, compute_dtype=dtype))
    return np.asarray(pallas_pair_pool_rect(
        cs[:, :, rows], cs, jnp.asarray(a[:, rows]), jnp.asarray(bb), prm,
        THR, row_classes=None if jcls is None else jcls[:, rows],
        col_classes=jcls, interpret=True, compute_dtype=dtype))


CASES = {
    "square": dict(b=2, n=64),
    "odd_padded": dict(b=1, n=101, n_valid=67),
    "multiclass": dict(b=2, n=48, num_classes=4),
    "p16": dict(b=2, n=40, p=16),
    "p8_padded": dict(b=2, n=56, n_valid=50, p=8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret_and_dense_f32(rng, name):
    case = _case(rng, **CASES[name])
    got = _port(*case)
    np.testing.assert_allclose(got, _pallas(*case), **F32_TOL)
    np.testing.assert_allclose(got, _jax_dense(*case), **DENSE_TOL)
    assert (got > 0).any()


@pytest.mark.parametrize("num_classes", [0, 3])
def test_plain_matches_pallas_rectangular(rng, num_classes):
    case = _case(rng, b=2, n=72, n_valid=60, num_classes=num_classes)
    rows = np.arange(9, 46)                       # NR = 37 != NC = 72
    got = _port(*case, rows=rows)
    assert got.shape == (2, 37, 32)
    np.testing.assert_allclose(got, _pallas(*case, rows=rows), **F32_TOL)
    np.testing.assert_allclose(got, _jax_dense(*case)[:, rows], **DENSE_TOL)


@pytest.mark.parametrize("num_classes", [0, 5])
def test_plain_bf16_matches_pallas_interpret_bf16(rng, num_classes):
    case = _case(rng, b=2, n=64, n_valid=50, num_classes=num_classes)
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
def test_block_sparse_flags_on_det_columns_are_exact(rng, block_sparse):
    """On CPU block_sparse changes nothing; the flags it would hand K5,
    read from the DetColumns layout (validity is field 13), are
    conservative: every neighbour pair lies in an active tile."""
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=2, n=150, n_valid=140)
    # x-sorted, so tiles are narrow in x and some tile pairs cannot meet
    boxes = np.take_along_axis(
        boxes, np.argsort(boxes[..., 0], axis=1)[..., None], axis=1)
    got = _port(boxes, scores, valid, cls, a, bb, w,
                block_sparse=block_sparse)
    np.testing.assert_allclose(
        got, _jax_dense(boxes, scores, valid, cls, a, bb, w), **DENSE_TOL)
    cs = _torch_cols(boxes, scores, valid)
    flags = k5.pair_columns(cs, cs, THR, block_sparse=block_sparse) \
        .flags.numpy()
    assert flags.shape == (2, 5, 3)          # ceil(150/32), ceil(150/64)
    _, mask = j_pf.dense_pair_tensor(_jax_cols(boxes, scores, valid), THR)
    bi, i, j = np.nonzero(np.asarray(mask))
    assert flags[bi, i // k5.TILE_I, j // k5.TILE_J].all()
    if block_sparse:
        assert flags.mean() < 1.0            # something is skipped
    else:
        assert (flags == 1).all()


def test_tile_flags_match_jax_tile_activity_with_padding(rng):
    boxes, scores, valid, *_ = _case(rng, b=2, n=128, n_valid=100)
    cs = _torch_cols(boxes, scores, valid)
    cols = k5.pair_columns(cs, cs, THR)
    jcs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    want = np.asarray(j_tiles(jnp.swapaxes(jcs, 1, 2), jcs, k5.TILE_I,
                              k5.TILE_J)).reshape(cols.flags.shape)
    np.testing.assert_array_equal(cols.flags.numpy(), want)
    assert cols.num_features == 8 and cols.row.shape[1] == 14
    with_cls = k5.pair_columns(cs, cs, THR, torch.zeros(2, 128))
    assert with_cls.num_features == 9 and with_cls.row.shape[1] == 15


@pytest.mark.parametrize("num_classes", [0, 4])
def test_plain_k5_equals_plain_k1_in_f32(rng, num_classes):
    """K5 and K1 compute one function: K1 folds the separable features
    into a and b, K5 computes them per pair."""
    case = _case(rng, b=2, n=80, n_valid=71, num_classes=num_classes)
    np.testing.assert_allclose(_port(*case), _port(*case, module=k1),
                               **F32_TOL)


def test_wrapper_never_falls_back_off_cpu(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    cs = _torch_cols(boxes, scores, valid)
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    before = k5.pair_pool.launches
    # A CUDA device with no card: raises, never a plain-version result.
    with pytest.raises((RuntimeError, AssertionError)):
        k5.pair_pool(cs.to("cuda"), cs.to("cuda"),
                     torch.from_numpy(a).to("cuda"),
                     torch.from_numpy(bb).to("cuda"), prm, THR)
    # Any other device is refused rather than computed on the CPU.
    meta = [t.to("meta") for t in (cs, torch.from_numpy(a),
                                   torch.from_numpy(bb))]
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        k5.pair_pool(meta[0], meta[0], meta[1], meta[2], prm, THR)
    # The kernel library itself refuses to load without a device.
    from gossipnet_tpu_torch.ops.cuda import build
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load("pairwise_fwd")
    with pytest.raises(ValueError, match="compute_dtype"):
        k5.pair_pool(cs, cs, torch.from_numpy(a), torch.from_numpy(bb), prm,
                     THR, compute_dtype="float16")
    assert k5.pair_pool.launches == before


def test_launch_wrappers_refuse_cpu_tensors(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    cs = _torch_cols(boxes, scores, valid)
    cols = k5.pair_columns(cs, cs, THR)
    t = [torch.from_numpy(x) for x in (a, bb, w["wg"], w["w2"], w["b2"])]
    before = (k5.pair_pool.launches, k5.pair_pool_backward.launches)
    with pytest.raises(RuntimeError, match="K5 kernel needs CUDA"):
        k5.launch_kernel(cols, *t, "float32")
    m = torch.zeros_like(t[0])
    with pytest.raises(RuntimeError, match="K6 kernel needs CUDA"):
        k5.launch_backward_kernel(cols, *t, m, m, "float32")
    assert (k5.pair_pool.launches, k5.pair_pool_backward.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["launch_kernel", "launch_backward_kernel"])
def test_launchers_refuse_cpu_tensors_in_either_dtype(rng, which, dtype):
    """K5 and K6 launch on CUDA tensors or raise: on CPU tensors neither
    launcher computes anything (no plain-version result, no launch
    counted), whatever the compute dtype and feature count."""
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=24,
                                                num_classes=3)
    cs = _torch_cols(boxes, scores, valid)
    c = torch.from_numpy(cls)
    cols = k5.pair_columns(cs, cs, THR, c, c)
    t = [torch.from_numpy(x) for x in (a, bb, w["wg"], w["w2"], w["b2"])]
    m = torch.zeros_like(t[0])
    extra = (m, m) if which == "launch_backward_kernel" else ()
    before = (k5.pair_pool.launches, k5.pair_pool_backward.launches)
    with pytest.raises(RuntimeError, match="kernel needs CUDA"):
        getattr(k5, which)(cols, *t, *extra, dtype)
    assert (k5.pair_pool.launches, k5.pair_pool_backward.launches) == before


@pytest.mark.parametrize("which,label", [("launch_kernel", "K5"),
                                         ("launch_backward_kernel", "K6")])
def test_launchers_check_that_pairs_pack(rng, monkeypatch, which, label):
    """K5 and K6 queue a pair as (row << 16) | column, as K1 and K2 do, so
    each launcher checks the detection counts (``check_packable``) under
    its own label before it launches."""
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    cs = _torch_cols(boxes, scores, valid)
    cols = k5.pair_columns(cs, cs, THR)
    t = [torch.from_numpy(x) for x in (a, bb, w["wg"], w["w2"], w["b2"])]
    seen = []

    class Reached(Exception):
        pass

    def fake_packable(lbl, geom):
        seen.append((lbl, geom))
        raise Reached

    monkeypatch.setattr(k5, "check_inputs", lambda *a_, **k_: None)
    monkeypatch.setattr(k5, "check_packable", fake_packable)
    extra = (t[0], t[0]) if label == "K6" else ()
    before = (k5.pair_pool.launches, k5.pair_pool_backward.launches)
    with pytest.raises(Reached):
        getattr(k5, which)(cols, *t, *extra, "float32")
    assert seen == [(label, cols)]
    assert (k5.pair_pool.launches, k5.pair_pool_backward.launches) == before


@pytest.mark.parametrize("label", ["K5", "K6"])
@pytest.mark.parametrize("side", ["rows", "cols"])
def test_k5_k6_refuse_more_detections_than_an_entry_packs(label, side):
    from gossipnet_tpu_torch.ops.cuda.launch import MAX_DETS, check_packable

    big, small = MAX_DETS + 1, 8
    nr, nc = (big, small) if side == "rows" else (small, big)
    cols = k5.PairColumns(torch.empty(1, 14, nr, device="meta"),
                          torch.empty(1, 14, nc, device="meta"), None, THR)
    with pytest.raises(ValueError, match=f"{label} takes at most"):
        check_packable(label, cols)
    check_packable(label, cols._replace(
        row=torch.empty(1, 14, MAX_DETS, device="meta"),
        col=torch.empty(1, 14, MAX_DETS, device="meta")))


@pytest.mark.parametrize("b,n,splits", [
    (2, 4096, 5),    # config 4: 256 row tiles of 64 column tiles
    (8, 1024, 5),    # the serving bench batch
    (8, 256, 17),    # an evaluation batch
    (1, 40, 8),      # one column tile: at most 8 steps to share
])
def test_col_splits_on_the_k5_k6_grid(rng, monkeypatch, b, n, splits):
    """The blocks that share a row tile in K5 and K6, from the flags of
    the columns as the model builds them, on a card of 132 SMs (H100
    SXM): enough for about eight blocks per SM, at most one split per
    step of two tests."""
    from gossipnet_tpu_torch.ops.cuda import launch

    boxes, scores, valid, *_ = _case(rng, b=b, n=n)
    cs = _torch_cols(boxes, scores, valid)
    cols = k5.pair_columns(cs, cs, THR)
    ni, nj = -(-n // launch.TILE_I), -(-n // launch.TILE_J)
    assert tuple(cols.flags.shape) == (b, ni, nj)
    monkeypatch.setattr(launch, "_sm_count", lambda index: 132)
    assert launch.col_splits(b * ni, nj, 132) == splits
    assert launch._splits(cols, torch.device("cpu")) == splits


# ---------------------------------------------------------------------------
# K6: the backward (the plain version, through PairPool1)
# ---------------------------------------------------------------------------


def _port_grads(boxes, scores, valid, cls, a, bb, w, cot, dtype="float32",
                rows=None, dup_cols=False):
    """Gradients of sum(m * cot) through pair_pool on CPU tensors: the
    plain forward and the plain backward of PairPool1."""
    cs = _torch_cols(boxes, scores, valid)
    row_cs, a_rows, col_cs, b_cols = cs, a, cs, bb
    tcls = None if cls is None else torch.from_numpy(cls)
    row_cls, col_cls = tcls, tcls
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows].contiguous(), a[:, rows]
        row_cls = None if tcls is None else tcls[:, rows]
    if dup_cols:
        col_cs = torch.repeat_interleave(cs, 2, dim=2)
        b_cols = np.repeat(bb, 2, axis=1)
        col_cls = None if tcls is None else torch.repeat_interleave(tcls, 2,
                                                                    dim=1)
    t = {"a": torch.from_numpy(np.ascontiguousarray(a_rows)),
         "b": torch.from_numpy(np.ascontiguousarray(b_cols)),
         **{k: torch.from_numpy(v) for k, v in w.items()}}
    for k in GRAD_FIELDS:
        t[k].requires_grad_(True)
    prm = PairParams(t["wa"], t["wb"], t["wg"], t["b1"], t["w2"], t["b2"])
    m = k5.pair_pool(row_cs, col_cs, t["a"], t["b"], prm, THR,
                     classes=row_cls, col_classes=col_cls,
                     compute_dtype=dtype)
    (m * torch.from_numpy(cot)).sum().backward()
    return {k: t[k].grad.numpy() for k in GRAD_FIELDS}


def _pallas_grads(boxes, scores, valid, cls, a, bb, w, cot, dtype="float32",
                  rows=None, dup_cols=False):
    """The same through the JAX TPU kernel's custom VJP, interpret mode."""
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    jcls = None if cls is None else jnp.asarray(cls)
    row_cs, a_rows, col_cs, b_cols = cs, a, cs, bb
    row_cls, col_cls = jcls, jcls
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows], a[:, rows]
        row_cls = None if jcls is None else jcls[:, rows]
    if dup_cols:
        col_cs = jnp.repeat(cs, 2, axis=2)
        b_cols = np.repeat(bb, 2, axis=1)
        col_cls = None if jcls is None else jnp.repeat(jcls, 2, axis=1)

    def f(a_, b_, wg, w2, b2):
        prm = JParams(jnp.asarray(w["wa"]), jnp.asarray(w["wb"]), wg,
                      jnp.asarray(w["b1"]), w2, b2)
        m = pallas_pair_pool_rect(
            row_cs, col_cs, a_, b_, prm, THR, row_classes=row_cls,
            col_classes=col_cls, interpret=True, compute_dtype=dtype)
        return jnp.sum(m * jnp.asarray(cot))

    grads = jax.grad(f, argnums=tuple(range(5)))(
        jnp.asarray(a_rows), jnp.asarray(b_cols), jnp.asarray(w["wg"]),
        jnp.asarray(w["w2"]), jnp.asarray(w["b2"]))
    return {k: np.asarray(g) for k, g in zip(GRAD_FIELDS, grads)}


def _assert_grads_close(got, want, bf16=False):
    for k in GRAD_FIELDS:
        if k in ("a", "b"):
            if bf16:
                _assert_bf16_close(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], **F32_TOL,
                                           err_msg=k)
        else:   # weight gradients: sums over every pair, of the max
            rel = 2e-2 if bf16 else 1e-4
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=rel * np.abs(want[k]).max(), err_msg=k)


BWD_CASES = {
    "odd_padded": dict(b=1, n=101, n_valid=67),
    "multiclass": dict(b=2, n=48, num_classes=4),
    "p16": dict(b=2, n=40, p=16),
}


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_matches_pallas_vjp_f32(rng, name):
    case = _case(rng, **BWD_CASES[name])
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _port_grads(*case, cot)
    _assert_grads_close(got, _pallas_grads(*case, cot))
    assert np.abs(got["b"]).max() > 0 and np.abs(got["wg"]).max() > 0
    assert got["wg"].shape == case[6]["wg"].shape   # every row of Wg


@pytest.mark.parametrize("num_classes", [0, 3])
def test_backward_matches_pallas_vjp_rectangular(rng, num_classes):
    case = _case(rng, b=2, n=72, n_valid=60, num_classes=num_classes)
    rows = np.arange(9, 46)
    cot = rng.normal(0, 1, (2, len(rows), 32)).astype(np.float32)
    _assert_grads_close(_port_grads(*case, cot, rows=rows),
                        _pallas_grads(*case, cot, rows=rows))


def test_backward_matches_pallas_vjp_bf16(rng):
    case = _case(rng, b=2, n=64, n_valid=50)
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _port_grads(*case, cot, dtype="bfloat16")
    _assert_grads_close(got, _pallas_grads(*case, cot, dtype="bfloat16"),
                        bf16=True)


def test_backward_gives_each_tie_the_full_gradient(rng):
    """Every column duplicated, so each max ties exactly between a column
    and its copy. The TPU kernel's VJP routes the full dm to each tie; so
    does PairPool1's plain backward, and the gradients match the JAX
    Pallas VJP in interpret mode."""
    case = _case(rng, b=2, n=40, num_classes=3)
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _port_grads(*case, cot, dup_cols=True)
    _assert_grads_close(got, _pallas_grads(*case, cot, dup_cols=True))
    single = _port_grads(*case, cot)
    np.testing.assert_array_equal(got["b"][:, 0::2], got["b"][:, 1::2])
    np.testing.assert_allclose(got["b"][:, 0::2], single["b"], **F32_TOL)
    np.testing.assert_allclose(got["a"], 2 * single["a"], **F32_TOL)
    for k in ("wg", "w2", "b2"):
        np.testing.assert_allclose(got[k], 2 * single[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(single[k]).max())
