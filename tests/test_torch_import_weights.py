"""The port's weight importer (``gossipnet_tpu_torch/utils/import_weights.py``
and ``tools/import_weights.py``) against the JAX package's.

A twin of each case of ``tests/test_import_weights.py``: a synthetic
reference-style variable dict (our tree re-emitted under guessed TF1
names, pair FC1 re-concatenated) goes through both importers. The port's
result, carried to a ``state_dict`` by ``params_from_jax``, must equal the
JAX importer's result carried the same way, bit for bit, and both must
equal the truth; where the JAX importer raises, the port raises the same
error with the same message (it names the same leaves). The CLI is held
end to end: variables NPZ in, params NPZ out, and the port's
``Rescorer(device="cpu")`` on it against the JAX ``Rescorer`` on it at
atol = 1e-5 (the same f32 model on both sides, as
``tests/test_torch_serving.py`` holds them).
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import Config as JConfig
from gossipnet_tpu.config import ModelConfig as JModelConfig
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu.utils import import_weights as jiw
from gossipnet_tpu.utils.export import load_params_npz as j_load_params_npz
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import ModelConfig, load_config
from gossipnet_tpu_torch.params import init_params, params_from_jax
from gossipnet_tpu_torch.utils import import_weights as iw
from gossipnet_tpu_torch.utils.export import load_params_npz

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_template(num_blocks=2, num_classes=1):
    cfg = JConfig(model=JModelConfig(num_blocks=num_blocks,
                                     num_classes=num_classes))
    model = j_build_model(cfg, "dense")
    n = 32
    args = [np.zeros((1, n, 4), np.float32), np.zeros((1, n), np.float32),
            np.ones((1, n), bool)]
    if num_classes > 1:
        args.append(np.zeros((1, n), np.int32))
    return model.init(jax.random.PRNGKey(0), *args)["params"]


def _template(num_blocks=2, num_classes=1):
    """The port's template: the flax-path tree of ``init_params``."""
    return init_params(ModelConfig(num_blocks=num_blocks,
                                   num_classes=num_classes))


def _randomized(template, seed=0):
    rng = np.random.default_rng(seed)
    flat = iw._flatten(iw.tree_to_numpy(template))
    return iw._unflatten({k: rng.normal(0, 1, flat[k].shape).astype(
        np.float32) for k in sorted(flat)})


def _to_reference_vars(params, fc1_order=("ri", "rj", "g"),
                       prefix="gnet/"):
    """Inverse mapping: our tree -> TF1-style flat variable dict (the
    reference test's helper)."""
    out = {}
    flat = iw._flatten(iw.tree_to_numpy(params))
    blocks = sorted({p.split("/")[0] for p in flat
                     if p.startswith("block_")})
    part = {"ri": "pair_wa", "rj": "pair_wb", "g": "pair_wg"}
    for b in blocks:
        k = b.split("_")[1]
        out[f"{prefix}block{k}/pair_fc1/weights"] = np.concatenate(
            [flat[f"{b}/{part[o]}"] for o in fc1_order], axis=0)
        out[f"{prefix}block{k}/pair_fc1/biases"] = flat[f"{b}/pair_b1"]
        out[f"{prefix}block{k}/pair_fc2/weights"] = flat[f"{b}/pair_w2"]
        out[f"{prefix}block{k}/pair_fc2/biases"] = flat[f"{b}/pair_b2"]
        out[f"{prefix}block{k}/reduce/weights"] = flat[f"{b}/reduce/kernel"]
        out[f"{prefix}block{k}/reduce/biases"] = flat[f"{b}/reduce/bias"]
        out[f"{prefix}block{k}/expand_1/weights"] = flat[f"{b}/expand/kernel"]
        out[f"{prefix}block{k}/expand_1/biases"] = flat[f"{b}/expand/bias"]
        out[f"{prefix}block{k}/expand_2/weights"] = \
            flat[f"{b}/expand_out/kernel"]
        out[f"{prefix}block{k}/expand_2/biases"] = \
            flat[f"{b}/expand_out/bias"]
    out[f"{prefix}init_fc/weights"] = flat["init_fc/kernel"]
    out[f"{prefix}init_fc/biases"] = flat["init_fc/bias"]
    out[f"{prefix}logits/weights"] = flat["head/kernel"]
    out[f"{prefix}logits/biases"] = flat["head/bias"]
    return out


def _assert_state_dicts_equal(a, b):
    sa, sb = params_from_jax(a), params_from_jax(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def _both(num_blocks, variables, **kw):
    """The port's and the JAX importer's results on ``variables``."""
    got, got_report = iw.import_params(_template(num_blocks), variables,
                                       **kw)
    want, want_report = jiw.import_params(_jax_template(num_blocks),
                                          variables, **kw)
    _assert_state_dicts_equal(got, jax.tree.map(np.asarray, want))
    assert got_report.assigned == want_report.assigned
    assert got_report.skipped_slots == want_report.skipped_slots
    assert got_report.unmatched_sources == want_report.unmatched_sources
    assert got_report.summary() == want_report.summary()
    return got, got_report


def _both_raise(num_blocks, variables, match, **kw):
    with pytest.raises(ValueError, match=match) as got:
        iw.import_params(_template(num_blocks), variables, **kw)
    with pytest.raises(ValueError, match=match) as want:
        jiw.import_params(_jax_template(num_blocks), variables, **kw)
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("num_classes", [1, 4])
def test_template_is_the_jax_models_tree(num_classes):
    """``init_params`` gives the leaves, shapes and dtypes of the flax
    model's own parameter tree: the importer's targets are the same."""
    got = iw._flatten(iw.tree_to_numpy(_template(2, num_classes)))
    want = iw._flatten(jax.tree.map(np.asarray,
                                    _jax_template(2, num_classes)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k


def test_roundtrip_default_rules():
    truth = _randomized(_template())
    variables = _to_reference_vars(truth)
    # Adam slots and bookkeeping must be skipped silently.
    variables["gnet/block0/reduce/weights/Adam"] = np.zeros((128, 32))
    variables["gnet/block0/reduce/weights/Adam_1"] = np.zeros((128, 32))
    variables["global_step"] = np.asarray(1000)
    variables["beta1_power"] = np.asarray(0.9)
    imported, report = _both(2, variables)
    _assert_state_dicts_equal(imported, truth)
    assert len(report.skipped_slots) == 4
    assert report.unmatched_sources == []


def test_fc1_order_changes_split():
    truth = _randomized(_template(num_blocks=1), seed=1)
    variables = _to_reference_vars(truth, fc1_order=("g", "ri", "rj"))
    wrong, _ = _both(1, variables)
    assert not np.array_equal(iw._flatten(wrong)["block_0/pair_wg"],
                              iw._flatten(truth)["block_0/pair_wg"])
    right, _ = _both(1, variables, fc1_order=("g", "ri", "rj"))
    _assert_state_dicts_equal(right, truth)


def test_missing_leaf_raises_with_inventory():
    variables = _to_reference_vars(_randomized(_template(num_blocks=1)))
    del variables["gnet/logits/weights"]
    msg = _both_raise(1, variables, "unassigned")
    assert "head/kernel" in msg            # the unassigned leaf
    assert "gnet/init_fc/weights" in msg   # the inventory


def test_shape_mismatch_raises():
    variables = _to_reference_vars(_randomized(_template(num_blocks=1)))
    variables["gnet/logits/weights"] = np.zeros((64, 1), np.float32)
    _both_raise(1, variables, "shape mismatch")


def test_custom_rules_and_transpose(tmp_path):
    """A --map JSON with transpose handles [out, in]-stored kernels."""
    truth = _randomized(_template(num_blocks=1), seed=2)
    variables = _to_reference_vars(truth)
    variables["gnet/logits/weights"] = variables["gnet/logits/weights"].T
    rules_path = tmp_path / "rules.json"
    rules_path.write_text(json.dumps(
        [{"pattern": r"gnet/logits/weights", "target": "head/kernel",
          "transpose": True}]
        + [{"pattern": r.pattern, "target": r.target}
           for r in iw.DEFAULT_RULES]))
    rules = iw.rules_from_json(rules_path)
    assert [(r.pattern, r.target, r.transpose) for r in rules] == [
        (r.pattern, r.target, r.transpose)
        for r in jiw.rules_from_json(rules_path)]
    got, _ = iw.import_params(_template(num_blocks=1), variables, rules)
    want, _ = jiw.import_params(_jax_template(num_blocks=1), variables,
                                jiw.rules_from_json(rules_path))
    _assert_state_dicts_equal(got, jax.tree.map(np.asarray, want))
    _assert_state_dicts_equal(got, truth)


def test_npz_variable_loading(tmp_path):
    truth = _randomized(_template(num_blocks=1), seed=3)
    path = tmp_path / "vars.npz"
    np.savez(path, **_to_reference_vars(truth))
    loaded = iw.load_variables(path)
    want = jiw.load_variables(path)
    assert sorted(loaded) == sorted(want)
    assert all(np.array_equal(loaded[k], want[k]) for k in loaded)
    assert iw.load_variable_shapes(path) == jiw.load_variable_shapes(path)
    imported, _ = _both(1, loaded)
    _assert_state_dicts_equal(imported, truth)


def test_cli_end_to_end(tmp_path):
    """tools/import_weights.py: NPZ of variables in -> params NPZ out,
    equal to the JAX CLI's import, and the port's Rescorer on it scores as
    the JAX Rescorer on it does."""
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(
        "model:\n  num_blocks: 2\ndata:\n  bucket_sizes: [32]\n")
    truth = _randomized(_template(num_blocks=2), seed=4)
    src = tmp_path / "ref_vars.npz"
    np.savez(src, **_to_reference_vars(truth))
    out = tmp_path / "imported.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT), HOME=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.tools.import_weights",
         "--src", str(src), "-c", str(cfg_path), "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "assigned" in r.stdout
    listed = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.tools.import_weights",
         "--src", str(src), "--list"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert listed.returncode == 0, listed.stderr
    assert "gnet/logits/weights: (128, 1)" in listed.stdout

    imported = load_params_npz(out)
    _assert_state_dicts_equal(imported, truth)
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 100, (10, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 15], axis=1)
    scores = rng.uniform(0, 1, 10).astype(np.float32)
    got = Rescorer(load_config(str(cfg_path)), imported,
                   device="cpu")(boxes, scores)
    want = JRescorer(j_load_config(str(cfg_path)), j_load_params_npz(out),
                     pool_impl="dense", mesh=None)(boxes, scores)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tf_checkpoint_loading(tmp_path):
    """load_variables against a genuine TF checkpoint (tensorflow is
    imported inside the loader only), the same variables as the JAX
    loader reads."""
    tf = pytest.importorskip("tensorflow")

    v1 = tf.Variable(np.arange(6, dtype=np.float32).reshape(2, 3),
                     name="gnet/logits/weights")
    v2 = tf.Variable(np.ones((3,), np.float32), name="gnet/logits/biases")
    ckpt = tf.train.Checkpoint(w=v1, b=v2)
    prefix = ckpt.save(str(tmp_path / "ref"))
    variables = iw.load_variables(prefix)
    want = jiw.load_variables(prefix)
    assert sorted(variables) == sorted(want)
    arrays = {tuple(np.shape(v)) for v in variables.values()}
    assert (2, 3) in arrays and (3,) in arrays
    assert iw.load_variable_shapes(prefix) == jiw.load_variable_shapes(prefix)
