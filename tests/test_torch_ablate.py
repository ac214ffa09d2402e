"""K7, the per-tile ablation of the pair tile: the port's plain version
against the TPU kernel itself, and the plain version with FC2 summed in
the order of the kernel's tensor-core product against the oracle's fmaf
order (the kernel's gate must hold that order).

``scripts/kernel_ablate.py`` runs and times at import and reads
``sys.argv``, so it cannot be imported. The test parses the file, takes the
function ``kernel`` alone, executes it in a namespace that supplies the
names it reads (MODE, TI, TJ, P, G, C, BF, pf, jnp, jax, pl), and launches
it with ``pl.pallas_call(..., interpret=True)`` under the script's grid and
block shapes.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gossipnet_tpu.ops import pair_features as jpf
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import ablate, pairwise
from gossipnet_tpu_torch.tools import kernel_ablate

ROOT = Path(__file__).resolve().parents[1]
B, N, TI, TJ = 2, 128, 64, 64
P, G, C = ablate.P, ablate.G, pf.NUM_COLUMNS


def tpu_kernel(mode: str):
    """``scripts/kernel_ablate.py::kernel`` compiled alone for ``mode``."""
    tree = ast.parse((ROOT / "scripts" / "kernel_ablate.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "kernel")
    ns = {"MODE": mode, "TI": TI, "TJ": TJ, "P": P, "G": G, "C": C,
          "BF": True, "pf": jpf, "jnp": jnp, "jax": jax, "pl": pl}
    exec(compile(ast.Module(body=[fn], type_ignores=[]),
                 "scripts/kernel_ablate.py", "exec"), ns)
    return ns["kernel"]


def tpu_pool(mode: str, inputs: dict) -> np.ndarray:
    """The script's ``pool`` in interpret mode on K7's inputs -> [B, N, P]
    (the script's layouts are the transposes)."""
    cols = jnp.asarray(inputs["cols"].numpy())
    args = (jnp.swapaxes(cols, 1, 2), cols,
            jnp.asarray(inputs["a"].numpy().transpose(0, 2, 1)),
            jnp.asarray(inputs["b"].numpy().transpose(0, 2, 1)),
            jnp.asarray(inputs["wg"].numpy().T),
            jnp.asarray(inputs["w2"].numpy().T),
            jnp.asarray(inputs["b2"].numpy()[:, None]))
    out = pl.pallas_call(
        tpu_kernel(mode),
        out_shape=jax.ShapeDtypeStruct((B, P, N), jnp.float32),
        grid=(B, N // TI, N // TJ),
        in_specs=[
            pl.BlockSpec((1, TI, C), lambda b, i, j: (b, i, 0)),
            pl.BlockSpec((1, C, TJ), lambda b, i, j: (b, 0, j)),
            pl.BlockSpec((1, P, TI), lambda b, i, j: (b, 0, i)),
            pl.BlockSpec((1, P, TJ), lambda b, i, j: (b, 0, j)),
            pl.BlockSpec((P, G), lambda b, i, j: (0, 0)),
            pl.BlockSpec((P, P), lambda b, i, j: (0, 0)),
            pl.BlockSpec((P, 1), lambda b, i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, P, TI), lambda b, i, j: (b, 0, i)),
        interpret=True,
    )(*args)
    return np.asarray(out).transpose(0, 2, 1)


@pytest.fixture(scope="module")
def inputs():
    """The probe's draws at B=2, N=128 in a 200-pixel canvas, so that
    neighbours and non-neighbours mix. Box 0 of each image sits at x1 = 0:
    its stand-in IoU in ``nofeat`` stays under the threshold against every
    box, a row without a neighbour."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 200, (B, N, 2))
    wh = rng.uniform(20, 80, (B, N, 2))
    xy[:, 0, 0] = 0.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    cols = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.ones((B, N), dtype=torch.bool))).contiguous()

    def normal(scale, shape):
        return torch.from_numpy(rng.normal(0, scale, shape)
                                .astype(np.float32))

    return {"cols": cols, "a": normal(1, (B, N, P)), "b": normal(1, (B, N, P)),
            "wg": normal(.3, (G, P)), "w2": normal(.3, (P, P)),
            "b2": normal(.3, (P,))}


def reference(inputs, mode):
    return ablate.pair_ablate_reference(
        inputs["cols"], inputs["a"], inputs["b"], inputs["wg"], inputs["w2"],
        inputs["b2"], mode).numpy()


@pytest.mark.parametrize("mode", ablate.MODES)
def test_plain_version_matches_the_tpu_kernel(inputs, mode):
    want = tpu_pool(mode, inputs)
    got = reference(inputs, mode)
    assert got.shape == (B, N, P) and np.isfinite(got).all()
    # rows without a neighbour hold the mask value in both
    np.testing.assert_array_equal(got < -1e29, want < -1e29)
    if mode == "bf3d":
        # bf16 elementwise: one bf16 step (2^-7 relative) everywhere, and
        # the same bits on at least 99% of the entries
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        assert np.mean(got == want) >= 0.99
    else:
        # bf16 operands are rounded identically; only the f32 summation
        # order differs
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nofeat_has_rows_without_a_neighbour(inputs):
    got = reference(inputs, "nofeat")
    want = tpu_pool("nofeat", inputs)
    empty = (got == ablate.NEG).all(axis=-1)
    assert empty[:, 0].all()                     # box 0 of each image
    np.testing.assert_array_equal(empty, (want == -1e30).all(axis=-1))
    # with the real IoU every box is its own neighbour
    assert (reference(inputs, "full") >= 0).all()


def test_full_equals_k5_plain_version_where_a_row_has_a_neighbour(inputs):
    """The same tile as K5 (``pair_kernel: 1``) in bf16 mode, but K5 folds b
    into the Wg chain and starts FC2 at b2: another f32 summation order.
    Where that moves an h1 across a bf16 rounding boundary (a few entries
    in ten thousand) the FC2 operand differs by one bf16 step, so: 1e-5 on
    at least 99.5% of the entries, the bf16 tolerance 2e-2 on all."""
    got = reference(inputs, "full")
    params = type("PairParams", (), {k: inputs[k] for k in ("wg", "w2", "b2")})
    k5 = pairwise.pair_pool_reference(
        inputs["cols"], inputs["cols"], inputs["a"], inputs["b"], params,
        neighbor_iou=0.2, compute_dtype="bfloat16").numpy()
    has = got > -1e29
    assert has.all()
    np.testing.assert_allclose(got, k5, rtol=2e-2, atol=2e-2)
    assert np.mean(np.isclose(got, k5, rtol=1e-5, atol=1e-5)) >= 0.995


@pytest.fixture(scope="module")
def ragged():
    """The card tests' small ragged case (tests/test_torch_cuda.py): B=2,
    N=200 (no multiple of any column tile) in a 200-pixel canvas,
    detections 150-169 of each image invalid."""
    got = kernel_ablate.probe_inputs(2, 200, canvas=200.0, seed=1)
    got["cols"][:, pf.DetColumns._fields.index("valid"), 150:170] = 0.0
    return got


@pytest.mark.parametrize("mode", ablate.MODES)
def test_the_gate_holds_the_tensor_core_order(ragged, mode):
    """The kernel sums FC2 on the tensor cores: two k blocks of 16, each
    block's exact products added to an f32 accumulator that starts at 0,
    b2 after. The plain version with FC2 in that order stays inside the kernel's
    gate around the fmaf-order oracle: rtol = atol = 1e-5 in the five f32
    modes, one bf16 step and >= 99% bit-equal in bf3d, rows without a
    neighbour at the same places; nofc2 has no FC2 and stays bit-equal."""
    args = [ragged[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    want = ablate.pair_ablate_reference(*args, mode).numpy()
    got = ablate.pair_ablate_reference(*args, mode, fc2_order="mma").numpy()
    np.testing.assert_array_equal(got < -1e29, want < -1e29)
    assert (want < -1e29).all(-1)[:, 150:170].all() or mode == "nomask"
    if mode == "bf3d":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        assert np.mean(got == want) >= 0.99
    elif mode == "nofc2":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (got != want).any()   # the order does move some outputs


def test_wrapper_checks_mode_tile_and_shapes(inputs):
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    out = ablate.pair_ablate(*args, "nomask", tile_j=128)
    np.testing.assert_array_equal(out.numpy(), reference(inputs, "nomask"))
    assert ablate.pair_ablate.launches == 0      # CPU tensors: no launch
    with pytest.raises(ValueError, match="32, 64, 128"):
        ablate.pair_ablate(*args, "full", tile_j=48)
    with pytest.raises(ValueError, match="mode must be one of"):
        ablate.pair_ablate(*args, "nofc1")
    with pytest.raises(ValueError, match="a: got"):
        ablate.pair_ablate(args[0], args[1][..., :16].contiguous(), *args[2:],
                           "full")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ablate.launch_kernel(*args, "full")
    assert ablate.tile_count(8, 1024, 64) == 8 * 32 * 16


def test_probe_inputs_are_the_scripts_draws():
    got = kernel_ablate.probe_inputs(batch=2, n=64)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 600, (2, 64, 2))
    wh = rng.uniform(20, 80, (2, 64, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    cols = jpf.stack_columns(jpf.det_columns(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.ones((2, 64), bool)))
    np.testing.assert_allclose(got["cols"].numpy(), np.asarray(cols),
                               rtol=1e-6, atol=1e-6)
    a_t = rng.normal(0, 1, (2, P, 64)).astype(np.float32)
    np.testing.assert_array_equal(got["a"].numpy(), a_t.transpose(0, 2, 1))
    assert got["wg"].shape == (G, P) and got["b2"].shape == (P,)


def test_tool_prints_the_scripts_line_on_the_cpu(capsys):
    results = kernel_ablate.main(
        ["full", "--device", "cpu", "--batch", "1", "-n", "64", "--calls",
         "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "MODE=full TI=32 TJ=64 BF=True:" in line
    assert "ms/call" in line and "us/tile" in line and "(sum=" in line
    assert line.startswith("cpu (plain version")
    assert results[0]["mode"] == "full" and np.isfinite(results[0]["sum"])
    assert results[0]["launches"] == 0           # the CPU launches nothing


def test_tool_all_prints_the_six_modes_and_the_differences(capsys):
    results = kernel_ablate.main(
        ["all", "32", "--device", "cpu", "--batch", "1", "-n", "64",
         "--calls", "1"])
    out = capsys.readouterr().out
    assert [r["mode"] for r in results] == list(ablate.MODES)
    for mode in ablate.MODES[1:]:
        assert f"full - {mode} =" in out
    with pytest.raises(SystemExit):
        kernel_ablate.main(["full", "48", "--device", "cpu"])
