"""Import reference (TF-1.x GossipNet) checkpoint weights into the
parameter tree: the port's copy of ``gossipnet_tpu/utils/import_weights.py``.

No checkpoint of the reference's authors is in the repository, so the
exact TF variable names are unverified. The importer therefore works from
a RULE LIST (regex -> target template) with liberal default guesses for
the py-faster-rcnn-style TF1 naming of the reference's class of code, and
refuses to emit a tree unless every parameter leaf is assigned exactly
once with matching shapes. A wrong guess against a real checkpoint is a
loud error with the full variable inventory to write a corrected --map
from, never silent garbage weights.

The target is the flax-path tree both packages share (``init_fc/kernel``,
``block_0/pair_wg``, ...): :func:`gossipnet_tpu_torch.params.init_params`
gives one for a config, ``params.params_to_jax`` turns a model's
``state_dict`` into one, and ``params.params_from_jax`` turns the result
into a ``state_dict``; ``utils/export.py::save_params_npz`` writes it as the
NPZ that ``Rescorer``, ``evaluate`` and the JAX package read.

Structural differences handled here:

- The reference's pair FC1 is ONE dense layer over the concatenation
  [r_i ; r_j ; g_ij]; the model splits that kernel into pair_wa / pair_wb /
  pair_wg (the row split the separable fold and the pair kernels use).
  Map the source kernel to the virtual target ``block_{k}/pair_fc1/kernel``
  and it is split by input-row ranges; the concat order is configurable
  (``fc1_order``).
- TF dense kernels are [in, out], as the flax-path tree's: no transposes by
  default; a per-rule ``transpose`` flag exists for safety.
- Optimizer slot variables (Adam moments, power accumulators,
  global_step) are recognized and skipped, not reported as unmatched.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Mapping

import numpy as np

# The '/'-joined path convention is shared with the NPZ interchange
# format: one implementation (utils/export.py) serves both.
from gossipnet_tpu_torch.utils.export import flatten_paths as _flatten
from gossipnet_tpu_torch.utils.export import unflatten_paths as _unflatten

__all__ = [
    "Rule", "DEFAULT_RULES", "ImportReport", "import_params",
    "load_variables", "load_variable_shapes", "rules_from_json",
    "tree_to_numpy",
]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One source-variable -> target-leaf mapping.

    ``pattern`` is a regex matched against the FULL source variable name
    (``re.fullmatch``); ``target`` is a format template where ``{0}``,
    ``{1}``, ... expand to the pattern's capture groups. The virtual
    targets ``.../pair_fc1/kernel`` and ``.../pair_fc1/bias`` trigger
    the FC1 row split (see module docstring).
    """

    pattern: str
    target: str
    transpose: bool = False


def _wb(*alts: str) -> str:
    """weights/bias alternation helper for the default rules."""
    return "(?:" + "|".join(alts) + ")"


_W = _wb("weights", "kernel", "w", "W")
_B = _wb("biases", "bias", "b")
# Optional TF scoping prefix (e.g. "gnet/", "Gnet/block...").
_PRE = r"(?:[\w.]+/)*?"

#: Liberal guesses for the reference's TF1 variable names. Order
#: matters: first match wins. All unverified against a real checkpoint:
#: override with rules_from_json(--map) against one.
DEFAULT_RULES: tuple[Rule, ...] = (
    Rule(_PRE + r"block_?(\d+)/reduce(?:_fc)?/" + _W,
         "block_{0}/reduce/kernel"),
    Rule(_PRE + r"block_?(\d+)/reduce(?:_fc)?/" + _B,
         "block_{0}/reduce/bias"),
    Rule(_PRE + r"block_?(\d+)/(?:pair|pairwise|joint|pw)_?fc_?1/" + _W,
         "block_{0}/pair_fc1/kernel"),
    Rule(_PRE + r"block_?(\d+)/(?:pair|pairwise|joint|pw)_?fc_?1/" + _B,
         "block_{0}/pair_fc1/bias"),
    Rule(_PRE + r"block_?(\d+)/(?:pair|pairwise|joint|pw)_?fc_?2/" + _W,
         "block_{0}/pair_w2"),
    Rule(_PRE + r"block_?(\d+)/(?:pair|pairwise|joint|pw)_?fc_?2/" + _B,
         "block_{0}/pair_b2"),
    Rule(_PRE + r"block_?(\d+)/(?:expand|up)(?:_fc)?_?1?/" + _W,
         "block_{0}/expand/kernel"),
    Rule(_PRE + r"block_?(\d+)/(?:expand|up)(?:_fc)?_?1?/" + _B,
         "block_{0}/expand/bias"),
    Rule(_PRE + r"block_?(\d+)/(?:expand|up)(?:_fc)?_?(?:2|out)/" + _W,
         "block_{0}/expand_out/kernel"),
    Rule(_PRE + r"block_?(\d+)/(?:expand|up)(?:_fc)?_?(?:2|out)/" + _B,
         "block_{0}/expand_out/bias"),
    Rule(_PRE + r"(?:init|input|det|feature)_?fc/" + _W, "init_fc/kernel"),
    Rule(_PRE + r"(?:init|input|det|feature)_?fc/" + _B, "init_fc/bias"),
    Rule(_PRE + r"(?:head|logits?|output|cls_score|score_fc)/" + _W,
         "head/kernel"),
    Rule(_PRE + r"(?:head|logits?|output|cls_score|score_fc)/" + _B,
         "head/bias"),
)

#: Source variables that are training state, not model weights.
_SLOT_RE = re.compile(
    r".*(?:/Adam(?:_\d+)?|/Momentum|_power|global_step|beta\d_power"
    r"|/ExponentialMovingAverage)$")


@dataclasses.dataclass
class ImportReport:
    """What the importer did — printed by the CLI, asserted by tests."""

    assigned: dict          # target leaf path -> source var name
    skipped_slots: list     # optimizer-state source vars ignored
    unmatched_sources: list  # model-looking vars no rule matched

    def summary(self) -> str:
        lines = [f"assigned {len(self.assigned)} leaves"]
        for tgt, src in sorted(self.assigned.items()):
            lines.append(f"  {src}  ->  {tgt}")
        if self.skipped_slots:
            lines.append(f"skipped {len(self.skipped_slots)} optimizer "
                         f"slot vars")
        if self.unmatched_sources:
            lines.append("UNMATCHED source variables (extend --map):")
            lines.extend(f"  {s}" for s in self.unmatched_sources)
        return "\n".join(lines)


def _fc1_slices(template_flat: dict, block: str,
                fc1_order: tuple[str, ...]):
    """(name, target-path, rows) triples for the FC1 row split, in
    source concat order. Errors stay on the importer's loud-failure
    contract: unknown blocks / order tokens raise ValueError naming
    the valid choices, never a bare KeyError."""
    missing = [f"{block}/{w}" for w in ("pair_wa", "pair_wb", "pair_wg")
               if f"{block}/{w}" not in template_flat]
    if missing:
        blocks = sorted({p.split("/")[0] for p in template_flat
                         if "/pair_wa" in p})
        raise ValueError(
            f"FC1 split: source variable maps to {block!r} but the "
            f"config's model has no such block (missing {missing}); "
            f"blocks in the template: {blocks} — check model.num_blocks "
            f"against the checkpoint")
    by_part = {"ri": (f"{block}/pair_wa",
                      template_flat[f"{block}/pair_wa"].shape[0]),
               "rj": (f"{block}/pair_wb",
                      template_flat[f"{block}/pair_wb"].shape[0]),
               "g": (f"{block}/pair_wg",
                     template_flat[f"{block}/pair_wg"].shape[0])}
    bad = [p for p in fc1_order if p not in by_part]
    if bad:
        raise ValueError(
            f"--fc1-order tokens {bad} unknown; valid: "
            f"{sorted(by_part)} (got {list(fc1_order)})")
    return [(part,) + by_part[part] for part in fc1_order]


def import_params(
    template, variables: dict[str, np.ndarray],
    rules: tuple[Rule, ...] = DEFAULT_RULES,
    fc1_order: tuple[str, ...] = ("ri", "rj", "g"),
) -> tuple[dict, ImportReport]:
    """Map ``variables`` (source name -> array) onto the structure of
    ``template`` (a flax-path tree of arrays or tensors, e.g. from
    ``init_params`` or ``params_to_jax(model.state_dict())``).

    Returns (params, report). Raises ValueError if any template leaf is
    left unassigned, assigned twice, or assigned a wrong shape — with
    the full variable inventory in the message so a corrected rule map
    can be written from the error alone.
    """
    template_flat = _flatten(tree_to_numpy(template))
    compiled = [(re.compile(r.pattern), r) for r in rules]
    assigned: dict[str, np.ndarray] = {}
    report = ImportReport({}, [], [])

    def assign(target: str, value: np.ndarray, src: str):
        if target not in template_flat:
            raise ValueError(
                f"rule for '{src}' names unknown target '{target}'; "
                f"known leaves:\n  " + "\n  ".join(sorted(template_flat)))
        if target in assigned:
            raise ValueError(
                f"target '{target}' assigned twice: by '{src}' and "
                f"'{report.assigned[target]}'")
        want = template_flat[target].shape
        if tuple(value.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch for '{target}' <- '{src}': "
                f"source {tuple(value.shape)}, expected {tuple(want)}")
        assigned[target] = np.asarray(value,
                                      template_flat[target].dtype)
        report.assigned[target] = src

    for name in sorted(variables):
        if _SLOT_RE.match(name):
            report.skipped_slots.append(name)
            continue
        value = np.asarray(variables[name])
        for pat, rule in compiled:
            m = pat.fullmatch(name)
            if not m:
                continue
            target = rule.target.format(*m.groups())
            if rule.transpose:
                value = value.T
            if target.endswith("/pair_fc1/kernel"):
                block = target[: -len("/pair_fc1/kernel")]
                row = 0
                for part, tgt, rows in _fc1_slices(template_flat, block,
                                                   fc1_order):
                    assign(tgt, value[row:row + rows], f"{name}[{part}]")
                    row += rows
                if row != value.shape[0]:
                    raise ValueError(
                        f"'{name}' has {value.shape[0]} input rows; the "
                        f"fc1 split consumed {row} (order {fc1_order}) — "
                        "pair-feature count mismatch?")
            elif target.endswith("/pair_fc1/bias"):
                block = target[: -len("/pair_fc1/bias")]
                assign(f"{block}/pair_b1", value, name)
            else:
                assign(target, value, name)
            break
        else:
            report.unmatched_sources.append(name)

    missing = sorted(set(template_flat) - set(assigned))
    if missing:
        raise ValueError(
            "import incomplete — unassigned parameter leaves:\n  "
            + "\n  ".join(missing)
            + "\n\nsource variables seen:\n  "
            + "\n  ".join(f"{n}: {tuple(np.shape(variables[n]))}"
                          for n in sorted(variables))
            + "\n\nWrite a --map JSON (list of {pattern, target"
            "[, transpose]}) covering these and re-run.")
    return _unflatten(assigned), report


def tree_to_numpy(tree):
    """Template leaves -> numpy (shape/dtype carriers only): numpy arrays
    as they are, tensors copied to the host."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def load_variables(path: str | Path) -> dict[str, np.ndarray]:
    """Read source variables from a .npz dump OR a TF checkpoint.

    TF checkpoints (both TF1 Saver and TF2 formats) are read with
    ``tf.train.load_checkpoint`` — pass the checkpoint PREFIX (the path
    without .index/.data suffixes), exactly as tf.train.Saver wrote it.
    TensorFlow is imported lazily: NPZ-only use never pays the import.
    """
    p = str(path)
    if p.endswith(".npz"):
        data = np.load(p)
        return {k: data[k] for k in data.files}
    import tensorflow as tf  # lazy: the NPZ path needs no TF

    reader = tf.train.load_checkpoint(p)
    shape_map = reader.get_variable_to_shape_map()
    return {name: reader.get_tensor(name) for name in shape_map}


def load_variable_shapes(path: str | Path) -> dict[str, tuple]:
    """Name -> shape inventory WITHOUT materializing tensors.

    The --list inspection step on a real reference checkpoint (conv
    backbone + Adam slots can be GBs) reads only the shape map; NPZ
    dumps are loaded normally (they are small here)."""
    p = str(path)
    if p.endswith(".npz"):
        return {k: tuple(np.shape(v)) for k, v in load_variables(p).items()}
    import tensorflow as tf  # lazy

    reader = tf.train.load_checkpoint(p)
    return {name: tuple(shape)
            for name, shape in reader.get_variable_to_shape_map().items()}


def rules_from_json(path: str | Path) -> tuple[Rule, ...]:
    """--map file: JSON list of {"pattern", "target"[, "transpose"]}."""
    doc = json.loads(Path(path).read_text())
    return tuple(Rule(d["pattern"], d["target"],
                      bool(d.get("transpose", False))) for d in doc)
