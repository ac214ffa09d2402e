"""K1 and K2 (pair-pool forward and backward): the port's plain versions
against the JAX TPU kernel and its custom VJP run in interpret mode and
against the JAX dense pair stage; the tie rule of the backward; the tile
flags; and the CUDA wrappers' refusal to fall back.

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

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import jax
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


# ---------------------------------------------------------------------------
# K2: the backward (the plain version, through the autograd Function)
# ---------------------------------------------------------------------------

GRAD_FIELDS = ("a", "b", "wg", "w2", "b2")


def _port_grads(boxes, scores, valid, cls, a, bb, w, cot, dtype="float32",
                rows=None, dup_cols=False):
    """Gradients of sum(m * cot) through pair_pool on CPU tensors: the
    plain forward and the plain backward of PairPool2."""
    cs = _torch_cols(boxes, scores, valid)
    row_cs, a_rows, col_cs, b_cols = cs, a, cs, bb
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows].contiguous(), a[:, rows]
    if dup_cols:
        col_cs = torch.repeat_interleave(cs, 2, dim=2)
        b_cols = np.repeat(bb, 2, axis=1)
    t = {"a": torch.from_numpy(np.ascontiguousarray(a_rows)),
         "b": torch.from_numpy(np.ascontiguousarray(b_cols)),
         **{k: torch.from_numpy(v) for k, v in w.items()}}
    for k in GRAD_FIELDS:
        t[k].requires_grad_(True)
    prm = PairParams(t["wa"], t["wb"], t["wg"], t["b1"], t["w2"], t["b2"])
    tcls = None if cls is None else torch.from_numpy(cls)
    row_cls = tcls if tcls is None or rows is None else tcls[:, rows]
    m = k1.pair_pool(row_cs, col_cs, t["a"], t["b"], prm, THR,
                     classes=row_cls, col_classes=tcls, compute_dtype=dtype)
    (m * torch.from_numpy(cot)).sum().backward()
    return {k: t[k].grad.numpy() for k in GRAD_FIELDS}


def _pallas_grads(boxes, scores, valid, cls, a, bb, w, cot, dtype="float32",
                  rows=None, dup_cols=False):
    """The same through the JAX TPU kernel's custom VJP, interpret mode."""
    cs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    jcls = None if cls is None else jnp.asarray(cls)
    row_cs, a_rows, col_cs, b_cols = cs, a, cs, bb
    row_cls = jcls
    if rows is not None:
        row_cs, a_rows = cs[:, :, rows], a[:, rows]
        row_cls = None if jcls is None else jcls[:, rows]
    if dup_cols:
        col_cs = jnp.repeat(cs, 2, axis=2)
        b_cols = np.repeat(bb, 2, axis=1)

    def f(a_, b_, wg, w2, b2):
        prm = JParams(jnp.asarray(w["wa"]), jnp.asarray(w["wb"]), wg,
                      jnp.asarray(w["b1"]), w2, b2)
        m = pallas_pair_pool_rect_v2(
            row_cs, col_cs, a_, b_, prm, THR, row_classes=row_cls,
            col_classes=jcls, interpret=True, compute_dtype=dtype)
        return jnp.sum(m * jnp.asarray(cot))

    grads = jax.grad(f, argnums=tuple(range(5)))(
        jnp.asarray(a_rows), jnp.asarray(b_cols), jnp.asarray(w["wg"]),
        jnp.asarray(w["w2"]), jnp.asarray(w["b2"]))
    return {k: np.asarray(g) for k, g in zip(GRAD_FIELDS, grads)}


def _assert_grads_close(got, want, bf16=False):
    for k in GRAD_FIELDS:
        if bf16 and k in ("b", "wg"):
            # The TPU kernel sums d_b's rows through two bf16 selector
            # matmuls, rounding each partial sum to bf16 once more; the
            # port sums the bf16-rounded dpre1 in f32 (as K2 does). d_b,
            # and wg's gradient through the fold of d_b, then hold to the
            # bf16 bound (2e-2, of the largest entry for wg) only.
            np.testing.assert_allclose(
                got[k], want[k], rtol=2e-2,
                atol=2e-2 * (np.abs(want[k]).max() if k == "wg" else 1.0),
                err_msg=k)
        elif k in ("a", "b"):
            if bf16:
                _assert_bf16_close(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], **F32_TOL,
                                           err_msg=k)
        else:   # weight gradients: sums over every pair, 1e-4 of the max
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


BWD_CASES = {
    "odd_padded": dict(b=1, n=101, n_valid=67),
    "multiclass": dict(b=2, n=48, num_classes=4),
}


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_matches_pallas_vjp_f32(rng, name):
    case = _case(rng, **BWD_CASES[name])
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _port_grads(*case, cot)
    _assert_grads_close(got, _pallas_grads(*case, cot))
    assert np.abs(got["b"]).max() > 0


def test_backward_matches_pallas_vjp_rectangular(rng):
    case = _case(rng, b=2, n=72, n_valid=60)
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
    does the port's CPU path (the plain backward of PairPool2), and the
    gradients match the JAX Pallas VJP in interpret mode. Autograd through
    the plain forward's amax would split each tie in half instead."""
    case = _case(rng, b=2, n=40)
    cot = rng.normal(0, 1, case[4].shape).astype(np.float32)
    got = _port_grads(*case, cot, dup_cols=True)
    _assert_grads_close(got, _pallas_grads(*case, cot, dup_cols=True))
    single = _port_grads(*case, cot)
    np.testing.assert_array_equal(got["b"][:, 0::2], got["b"][:, 1::2])
    np.testing.assert_allclose(got["b"][:, 0::2], single["b"], **F32_TOL)
    np.testing.assert_allclose(got["a"], 2 * single["a"], **F32_TOL)
    np.testing.assert_allclose(got["b2"], 2 * single["b2"], rtol=1e-5,
                               atol=1e-5)
    # the split rule, for contrast: autograd through the plain forward
    boxes, scores, valid, cls, a, bb, w = case
    cs = _torch_cols(boxes, scores, valid)
    dup = torch.repeat_interleave(cs, 2, dim=2)
    bt = torch.from_numpy(np.repeat(bb, 2, axis=1)).requires_grad_(True)
    prm = PairParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    m = k1.pair_pool_reference(cs, dup, torch.from_numpy(a), bt, prm, THR,
                               compute_dtype="float32")
    (m * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy()[:, 0::2], single["b"] / 2,
                               rtol=1e-5, atol=1e-5)


def test_backward_wrapper_never_falls_back_off_cpu(rng):
    boxes, scores, valid, cls, a, bb, w = _case(rng, b=1, n=16)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR)
    t = [torch.from_numpy(x) for x in (a, bb, w["wg"][:3], w["w2"], w["b2"])]
    m = torch.zeros_like(t[0])
    before = k1.pair_pool_backward.launches
    with pytest.raises(RuntimeError, match="K2 kernel needs CUDA"):
        k1.launch_backward_kernel(geom, *t, m, m, "float32")
    assert k1.pair_pool_backward.launches == before


# ---------------------------------------------------------------------------
# the launch plumbing of the redesigned K1 / K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks, nj, sms, want", [
    (256, 16, 132, 5),     # B=8 N=1024: 1280 blocks for 132 SMs
    (64, 4, 132, 17),      # B=8 N=256: the small evaluation batch still fills
    (256, 64, 132, 5),     # B=2 N=4096
    (4096, 16, 132, 1),    # more tiles than the card needs: no split
    (1, 1, 132, 8),        # one tile of the other side is eight steps
    (0, 0, 132, 1),        # an empty launch
])
def test_col_splits_fill_the_card(blocks, nj, sms, want):
    from gossipnet_tpu_torch.ops.cuda.launch import col_splits

    got = col_splits(blocks, nj, sms)
    assert got == want
    assert 1 <= got <= max(8 * nj, 1)
    # about eight blocks per multiprocessor, never a split without a step
    if got > 1:
        assert blocks * (got - 1) < 8 * sms


def test_pair_entries_refuse_more_detections_than_they_pack(rng):
    from gossipnet_tpu_torch.ops.cuda.launch import MAX_DETS, check_packable

    ok = _fake_geom(MAX_DETS, 17)
    check_packable("K1", ok)
    with pytest.raises(ValueError, match="at most"):
        check_packable("K1", _fake_geom(MAX_DETS + 1, 17))
    with pytest.raises(ValueError, match="at most"):
        check_packable("K2", _fake_geom(8, MAX_DETS + 1))


def _fake_geom(nr, nc):
    from types import SimpleNamespace

    return SimpleNamespace(row=torch.empty(1, 8, nr, device="meta"),
                           col=torch.empty(1, 8, nc, device="meta"))


@pytest.mark.parametrize("splits", [1, 3])
def test_backward_launch_scratch_and_sums(rng, monkeypatch, splits):
    """What the wrapper hands K2 and what it makes of its outputs, with the
    launch replaced: every gradient comes back as the kernel wrote it (the
    kernel sums its slices and its weight partials itself; nothing is
    summed here), the scratch has one slice per split, one row of weight
    partials per block and split, one ``work`` entry per block of the
    grids and one region of 32 x P records per image and row tile, and the
    count of blocks launched is the grids'. No [B, NI, NC, P] tensor is
    made."""
    from gossipnet_tpu_torch.ops.cuda import launch

    b, nr, nc, p, k = 2, 70, 100, 16, 3
    geom = _fake_geom(nr, nc)
    ni, nj = -(-nr // launch.TILE_I), -(-nc // launch.TILE_J)
    nt = ni + -(-nc // launch.BLOCK_ROWS)
    geom.flags = torch.ones(b, ni, nj, dtype=torch.int32)
    geom.neighbor_iou = THR
    seen = {}
    words = k * p + p * p + p

    def fake_launch(name, label, entry, tiles, geom_, tensors, p_, k_,
                    splits_, dtype):
        seen["shapes"] = [tuple(t.shape) for t in tensors]
        seen["splits"] = splits_
        da, db = tensors[10], tensors[11]
        da.fill_(1.0)
        db.fill_(2.0)
        tensors[15].copy_(torch.arange(words))

    monkeypatch.setattr(launch, "_launch", fake_launch)
    monkeypatch.setattr(launch, "_splits", lambda geom_, device, **kw: splits)
    t = lambda *s: torch.zeros(*s)
    counts = torch.zeros(3, dtype=torch.int64)
    (da, db, dwg, dw2, db2), launched = launch.backward_launch(
        "pairwise2_bwd", "K2", "e", "t", geom, t(b, nr, p), t(b, nc, p),
        t(k, p), t(p, p), t(p), t(b, nr, p), t(b, nr, p), counts, "float32")
    assert seen["splits"] == splits
    shapes = seen["shapes"]
    assert shapes[10] == (b, nr, p) and shapes[11] == (b, nc, p)
    assert shapes[12] == (splits, b, nr, p)
    assert shapes[13] == (splits, b, nc, p)
    assert shapes[14:] == [(splits * b * ni, words), (words,),
                           (splits, b, nt), (3,), (b, ni, 32 * p, p),
                           (b, ni, 32 * p), (b, ni + 1)]
    assert launched == splits * b * nt
    assert (b, ni, nc, p) not in shapes
    assert da.shape == (b, nr, p) and bool((da == 1.0).all())
    assert db.shape == (b, nc, p) and bool((db == 2.0).all())
    whole = torch.arange(words, dtype=torch.float32)
    for g, shape, part in ((dwg, (k, p), whole[:k * p]),
                           (dw2, (p, p), whole[k * p:k * p + p * p]),
                           (db2, (p,), whole[k * p + p * p:])):
        assert g.shape == shape and torch.equal(g.flatten(), part)


@pytest.mark.parametrize("splits", [1, 4])
def test_k6_launch_keeps_its_row_tile_partial(rng, monkeypatch, splits):
    """K6 no longer keeps a row-tile partial: it takes the splits and one
    scratch slice of d_a and d_b per split (none for one
    split), with d_b [B, NC, P] written by the kernel as it is; no
    [B, NI, NC, P] tensor is made, zero-filled or summed. Its nine
    feature rows of dWg come back summed over the blocks and splits."""
    from gossipnet_tpu_torch.ops.cuda import launch
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    b, nr, nc, p, k = 1, 40, 70, 8, 9
    geom = _fake_geom(nr, nc)
    ni = -(-nr // launch.TILE_I)
    geom.flags = torch.ones(b, ni, -(-nc // launch.TILE_J), dtype=torch.int32)
    seen = {}

    def fake_launch(name, label, entry, tiles, geom_, tensors, p_, k_,
                    splits_, dtype):
        seen["n"], seen["splits"] = len(tensors), splits_
        seen["shapes"] = [tuple(t.shape) for t in tensors]
        tensors[11].fill_(1.0)
        for t in (tensors[10], *tensors[-3:]):
            t.fill_(0.25)

    monkeypatch.setattr(launch, "_launch", fake_launch)
    monkeypatch.setattr(launch, "_splits", lambda geom_, device, **kw: splits)
    t = lambda *s: torch.zeros(*s)
    _, db, dwg, *_ = k5.backward_launch(
        geom, t(b, nr, p), t(b, nc, p), t(k, p), t(p, p), t(p),
        t(b, nr, p), t(b, nr, p), "float32")
    assert seen["n"] == 17 and seen["splits"] == splits
    s0 = splits if splits > 1 else 0
    assert seen["shapes"][11:14] == [(b, nc, p), (s0, b, nr, p),
                                     (s0, b, nc, p)]
    assert (b, ni, nc, p) not in seen["shapes"]
    assert db.shape == (b, nc, p) and bool((db == 1.0).all())
    assert dwg.shape == (k, p)
    assert bool((dwg == 0.25 * splits * b * ni).all())


@pytest.mark.parametrize("label,k,c", [("K1", 3, 8), ("K5", 9, 15)])
@pytest.mark.parametrize("splits", [1, 6])
def test_forward_launch_hands_the_kernel_its_splits(monkeypatch, label, k,
                                                    c, splits):
    """K1 and K5 take one launch: the tensors, then (B, NR, NC, P, K) and
    the splits of :func:`col_splits`; the output is a fresh [B, NR, P]
    (the C entry zero-fills it when the splits merge into it)."""
    from gossipnet_tpu_torch.ops.cuda import launch

    b, nr, nc, p = 2, 45, 100, 16
    geom = _fake_geom(nr, nc)
    geom.flags = torch.ones(b, -(-nr // launch.TILE_I),
                            -(-nc // launch.TILE_J), dtype=torch.int32)
    seen = {}

    def fake_launch(name, label_, entry, tiles, geom_, tensors, p_, k_,
                    splits_, dtype):
        seen.update(n=len(tensors), p=p_, k=k_, splits=splits_,
                    label=label_, out=tuple(tensors[-1].shape))

    monkeypatch.setattr(launch, "_launch", fake_launch)
    monkeypatch.setattr(launch, "_splits", lambda geom_, device, **kw: splits)
    t = lambda *s: torch.zeros(*s)
    out = launch.forward_launch("lib", label, "e", "t", geom, t(b, nr, p),
                                t(b, nc, p), t(k, p), t(p, p), t(p),
                                "bfloat16")
    assert seen == dict(n=9, p=p, k=k, splits=splits, label=label,
                        out=(b, nr, p))
    assert out.shape == (b, nr, p)


# ---------------------------------------------------------------------------
# the forward's neighbour list: the list kernel's plain twin
# ---------------------------------------------------------------------------

LIST_CASES = {
    "odd_padded": dict(b=1, n=101, n_valid=67),
    "multiclass": dict(b=2, n=48, num_classes=4),
    "tile_32x16": dict(b=2, n=150, n_valid=140, tile=(32, 16)),
    "tile_64x128": dict(b=1, n=300, tile=(64, 128)),
    "row_slice": dict(b=2, n=120, rows=slice(40, 104)),
}


def _list_geom(rng, b, n, n_valid=None, num_classes=0, tile=None,
               rows=slice(None)):
    """A CPU geometry of clustered detections sorted by x (so whole tiles
    are skipped), its rows ``rows`` of the columns."""
    boxes, scores, valid, cls, *_ = _case(rng, b=b, n=n, n_valid=n_valid,
                                          num_classes=num_classes, p=8)
    boxes = np.take_along_axis(
        boxes, np.argsort(boxes[..., 0], axis=1)[..., None], axis=1)
    cs = _torch_cols(boxes, scores, valid)
    tcls = None if cls is None else torch.from_numpy(cls)
    return k1.pair_geometry(
        cs[:, :, rows].contiguous(), cs, THR,
        None if tcls is None else tcls[:, rows].contiguous(), tcls, tile=tile)


def _plain_pairs(geom):
    """The plain version's neighbour mask [B, NR, NC] and f32 features
    [B, NR, NC, K] (``_pair_chunks``)."""
    bsz, _, nr = geom.row.shape
    nc, p = geom.col.shape[2], 8
    k = 4 if geom.multiclass else 3
    z = torch.zeros
    nb, g = zip(*((nb_, g_) for _, nb_, g_, _, _ in k1._pair_chunks(
        geom, z(bsz, nr, p), z(bsz, nc, p), z(k, p), z(p, p), z(p),
        "float32")))
    return torch.cat(nb, 1), torch.cat(g, 1)


def _part_of(c, tj):
    """The list kernel's part of column c: its warp's quarter of the tile of
    TJ columns, and the split of its step of two columns."""
    item = (c // tj) * (tj // 8) + (c % (tj // 4)) // 2
    return (item % k1.LIST_SPLITS) * 4 + (c % tj) // (tj // 4)


@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_list_twin_holds_each_row_tiles_neighbours_in_kernel_order(rng,
                                                                   name):
    """Each row tile's list holds exactly the plain version's neighbour
    pairs of its rows in the cells the flags keep, each once, with the
    plain version's features bit for bit (the class match, or 0); a part
    holds the columns of its warp and split, ascending, each column's rows
    ascending. The list is built on CUDA tensors only."""
    geom = _list_geom(rng, **LIST_CASES[name])
    assert geom.pairs is None
    lst = k1.pair_list_reference(geom)
    bsz, _, nr = geom.row.shape
    nc = geom.col.shape[2]
    fi, tj = geom.tile
    ni, cap = -(-nr // 32), min(nc, k1.LIST_ROW_BUDGET)
    assert lst.ij.shape == (bsz, ni, k1.LIST_PARTS, cap)
    assert lst.g.shape == (bsz, ni, k1.LIST_PARTS, cap, 4)
    assert (lst.count <= cap).all()
    nb, g = _plain_pairs(geom)
    kept = geom.flags.repeat_interleave(fi, 1).repeat_interleave(
        tj, 2)[:, :nr, :nc] != 0
    assert bool((nb & ~kept).sum() == 0)    # the flags skip no neighbour
    k = g.shape[-1]
    total = 0
    for b in range(bsz):
        for t in range(ni):
            want = {(i, j) for i, j in (nb[b, 32 * t:32 * t + 32]
                                        & kept[b, 32 * t:32 * t + 32])
                    .nonzero().tolist()}
            got = set()
            for part in range(k1.LIST_PARTS):
                n = int(lst.count[b, t, part])
                ij = lst.ij[b, t, part, :n].long()
                i, j = ij >> 16, ij & 0xffff
                assert bool((_part_of(j, tj) == part).all())
                order = j * nr + i
                assert bool((order[1:] > order[:-1]).all())
                got |= {(int(x) - 32 * t, int(y)) for x, y in zip(i, j)}
                feats = lst.g[b, t, part, :n]
                assert torch.equal(feats[:, :k], g[b, i, j])
                if k == 3:
                    assert bool((feats[:, 3] == 0).all())
            assert got == want, (b, t)
            total += len(want)
    assert total == int(lst.count.sum()) > 0
    assert bool((lst.count == 0).any())     # some parts meet no neighbour


@pytest.mark.parametrize("capacity", [0, 1, 3])
def test_list_twin_marks_exactly_the_overflowing_row_tiles_dense(
        rng, capacity):
    """With room for ``capacity`` entries a part, a part still counts every
    neighbour it finds and holds the first ``capacity`` of the full list's;
    a row tile is dense (``list_groups`` -1) exactly where a part's count
    passes its room, and otherwise holds its groups' worth of entries."""
    geom = _list_geom(rng, b=2, n=160, n_valid=100)
    full = k1.pair_list_reference(geom)
    small = k1.pair_list_reference(geom, capacity=capacity)
    assert small.ij.shape[-1] == capacity
    assert torch.equal(small.count, full.count)
    over = (full.count > capacity).any(-1)
    groups = k1.list_groups(small, 16)
    assert torch.equal(groups < 0, over)
    assert bool(over.any()) and bool((~over).any())
    held = full.count.clamp(max=capacity)
    slot = torch.arange(capacity)
    fits = slot < held[..., None]
    assert torch.equal(small.ij[fits], full.ij[..., :capacity][fits])
    assert torch.equal(small.g[fits], full.g[..., :capacity, :][fits])
    whole = k1.list_groups(full, 16)
    assert bool((whole >= 0).all())
    assert torch.equal(groups[~over], whole[~over])
    assert torch.equal(whole, -(-full.count.sum(-1) // 16))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_a_launch_reads_its_geometrys_list_and_raises_without_one(
        rng, monkeypatch, kernel):
    """K1 and K2 hand their entries the geometry's own list, and raise
    before any launch on a geometry without one (a CPU geometry) or with
    one of another shape (a row shard cut by ``_replace`` that kept the
    square launch's list)."""
    geom = _list_geom(rng, b=1, n=64)
    assert geom.pairs is None
    lst = k1.pair_list_reference(geom)
    seen = []

    def fake(*a, extra=(), **kw):
        seen.append(extra)
        return (a[0], a[0], a[0], a[0], a[0]), 0

    monkeypatch.setattr(k1, "check_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(k1, "forward_launch", fake)
    monkeypatch.setattr(k1, "backward_launch", fake)
    t = torch.zeros(1)
    if kernel == "K1":
        def go(g):
            return k1.launch_kernel(g, t, t, t, t, t, "float32")
    else:
        def go(g):
            return k1.launch_backward_kernel(g, t, t, t, t, t, t, t,
                                             "float32")
    # a row shard made by _replace, still holding the square launch's list
    shard = geom._replace(row=geom.row[:, :, :32].contiguous(), pairs=lst)
    for bad in (geom, shard):
        with pytest.raises(ValueError, match=kernel):
            go(bad)
    assert seen == []
    go(geom._replace(pairs=lst))
    assert all(x is y for x, y in zip(seen[0], lst))
