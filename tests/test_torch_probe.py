"""``tools/probe.py`` on the CPU: every mode runs at a tiny size (2 blocks,
N=64) with the plain versions of the kernels, the tile-activity fractions
equal the JAX probe's (``scripts/probe.py::mode_activity``) exactly on the
same layouts, and ``--ew-dtype bfloat16`` raises as the model does.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import argparse
import importlib.util
import pathlib

import jax.numpy as jnp
import pytest

from gossipnet_tpu_torch.tools import probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--blocks", "2", "--n", "64", "--batch", "2",
        "--iters", "3"]


def _reference_probe():
    spec = importlib.util.spec_from_file_location(
        "reference_probe", ROOT / "scripts" / "probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mode,impl", [
    ("forward", "pallas"), ("forward", "pallas1"), ("forward", "dense"),
    ("step", "pallas"), ("step", "pallas1"), ("match", "pallas"),
    ("parity", "pallas"), ("parity", "pallas1"), ("loop", "pallas"),
    ("activity", "pallas")])
def test_each_mode_runs_on_the_cpu(capsys, mode, impl):
    result = probe.main([mode, *TINY, "--impl", impl])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "DONE"
    if mode == "parity":
        assert result < 2e-2
    if mode == "loop":
        assert "host vs device loop max diff: 0.0" in out


def test_train_mode_reports_a_marginal_step(capsys):
    marginal = probe.main(["train", *TINY[:-4], "--batch", "1"])
    out = capsys.readouterr().out
    assert "marginal train step" in out and "K=25" in out
    assert isinstance(marginal, float)


@pytest.mark.parametrize("layout", ["clustered", "uniform", "mixed", "blob"])
def test_activity_equals_the_jax_probe_exactly(capsys, layout):
    ref = _reference_probe()
    args = argparse.Namespace(
        mode="activity", batch=2, n=256, blocks=2, iters=3, impl="pallas",
        layout=layout, dtype="bfloat16", ew_dtype="float32")
    ref.mode_activity(args)
    want_line = capsys.readouterr().out.strip().splitlines()[0]
    # the JAX probe's own computation, to full precision
    _, _, d = ref._model_and_data(args)
    key = jnp.where(d["valid"],
                    0.5 * (d["boxes"][..., 0] + d["boxes"][..., 2]), jnp.inf)
    perm = jnp.argsort(key, axis=-1)
    boxes = jnp.take_along_axis(d["boxes"], perm[..., None], axis=-2)
    scores = jnp.take_along_axis(d["scores"], perm, axis=-1)
    valid = jnp.take_along_axis(d["valid"], perm, axis=-1)
    from gossipnet_tpu.ops import pair_features as jpf
    from gossipnet_tpu.ops.pallas.pairwise import _tile_activity

    cs = jpf.stack_columns(jpf.det_columns(boxes, scores, valid))
    want = float(jnp.mean(_tile_activity(jnp.swapaxes(cs, 1, 2), cs, 128,
                                         128).astype(jnp.float32)))

    got = probe.main(["activity", "--device", "cpu", "--batch", "2",
                      "--n", "256", "--layout", layout])
    lines = capsys.readouterr().out.strip().splitlines()
    assert got["x-sorted 128x128"] == want
    assert lines[0] == want_line
    assert 0.0 < got["morton 32x64"] <= 1.0


def test_elementwise_bfloat16_runs_the_bf16_stream(capsys):
    """``--ew-dtype bfloat16`` (pair_elementwise_dtype) is ported: the
    forward probe runs K1's bf16 stream (its plain version here)."""
    probe.main(["forward", *TINY, "--ew-dtype", "bfloat16"])
    assert "forward" in capsys.readouterr().out


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown --impl"):
        probe.main(["forward", *TINY, "--impl", "pallas3"])
