"""The scale drill and the convert step in the port
(``gossipnet_tpu_torch/tools/scale_drill.py``, ``tools/prepare_data.py``)
against the reference's scripts, loaded by path: the generators write the
reference's bytes, every arm writes YAMLs that load to the same config in
both packages and runs the port's CLIs with ``--device``, ``eval5k`` and
``convert`` give the reference's results, and the ``run`` arm runs end to
end on the CPU at a tiny size."""

import torch_cpu  # noqa: F401  (first: one torch thread)
import argparse
import dataclasses
import hashlib
import importlib.util
import json
import re
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu_torch.config import load_config as t_load_config
from gossipnet_tpu_torch.data.roidb import build_roidb
from gossipnet_tpu_torch.tools import prepare_data
from gossipnet_tpu_torch.tools import scale_drill as sd

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", str(SCRIPTS / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference("scale_drill")
REF_PD = _reference("prepare_data")
# the reference's command line, run in its module's namespace
REF_MAIN = textwrap.dedent((SCRIPTS / "scale_drill.py").read_text().split(
    'if __name__ == "__main__":\n', 1)[1])


def _same_files(a: Path, b: Path, names) -> None:
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("kw", [
    dict(n_images=6), dict(n_images=3, **REF.DENSE_P),
    dict(n_images=2, **REF.DENSE_4K), dict(n_images=6, score_corr=0.8),
    dict(n_images=4, seed=1, prefix="val_")],
    ids=["default", "dense_p", "dense_4k", "score_corr", "val_split"])
def test_gen_writes_the_reference_bytes(tmp_path, monkeypatch, kw):
    monkeypatch.setattr(REF, "DATA", tmp_path / "ref")
    REF.gen(**kw)
    got = sd.gen(data_dir=tmp_path / "port", **kw)
    prefix = kw.get("prefix", "")
    _same_files(tmp_path / "ref", tmp_path / "port",
                [f"{prefix}annotations.json", f"{prefix}detections.json"])
    ann = json.loads((tmp_path / "port" / f"{prefix}annotations.json")
                     .read_text())
    assert got == {"images": kw["n_images"],
                   "annotations": len(ann["annotations"]),
                   "detections": len(json.loads(
                       (tmp_path / "port" / f"{prefix}detections.json")
                       .read_text()))}


@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_gen_pets_writes_the_reference_bytes(tmp_path, monkeypatch, alpha):
    monkeypatch.setattr(REF, "DATA", tmp_path / "ref")
    REF.gen_pets(n_frames=4, score_corr=alpha)
    sd.gen_pets(n_frames=4, score_corr=alpha, data_dir=tmp_path / "port")
    _same_files(tmp_path / "ref", tmp_path / "port",
                ["pets_gt.xml", "pets_dets.csv"])


def test_phase_19_hashes_are_the_reference_generators(tmp_path, monkeypatch):
    """The constants ``chip_smoke.py`` holds the card machine's files to
    are the reference generator's bytes."""
    import chip_smoke

    monkeypatch.setattr(REF, "DATA", tmp_path)
    REF.gen(n_images=chip_smoke.DRILL_IMAGES)
    REF.gen_pets(n_frames=chip_smoke.DRILL_FRAMES)
    assert {name: hashlib.sha256((tmp_path / name).read_bytes()).hexdigest()
            for name in chip_smoke.DRILL_SHA256} == chip_smoke.DRILL_SHA256


def test_max_iou_same_cat_many_equals_the_reference():
    rng = np.random.default_rng(0)
    cases = [([], [], [(1, [0, 0, 5, 5])]), ([[0, 0, 5, 5]], [1], []),
             # coincident, touching, zero-size, other category
             ([[0, 0, 5, 5], [5, 0, 5, 5], [1, 1, 0, 4], [0, 0, 5, 5]],
              [1, 1, 1, 2], [(1, [0, 0, 5, 5]), (1, [0, 0, 5, 5])])]
    for _ in range(200):
        d, g = int(rng.integers(0, 12)), int(rng.integers(0, 6))
        boxes = rng.uniform(0, 50, (d, 4)) * (rng.uniform(size=(d, 1)) > 0.1)
        gts = [(int(rng.integers(1, 4)), list(rng.uniform(0, 50, 4)))
               for _ in range(g)]
        cases.append((boxes.tolist(), rng.integers(1, 4, d).tolist(), gts))
    for dets, cats, gts in cases:
        got = sd._max_iou_same_cat_many(dets, cats, gts)
        want = REF._max_iou_same_cat_many(dets, cats, gts)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# tests/test_scale_drill_args.py's cases: (call, expected)
ARG_CASES = {
    "flags_in_order": (lambda m: m._parse_arm_args(
        ["3000", "1e-3", "cosine", "mt", "alpha=0.8"], "constant"),
        (3000, 1e-3, "cosine", True, 0.8, [])),
    "flags_first": (lambda m: m._parse_arm_args(
        ["mt", "3000", "alpha=0.8", "1e-3", "cosine"], "constant"),
        (3000, 1e-3, "cosine", True, 0.8, [])),
    "alpha_first": (lambda m: m._parse_arm_args(
        ["alpha=0.8", "mt", "3000", "1e-3", "cosine"], "constant"),
        (3000, 1e-3, "cosine", True, 0.8, [])),
    "extra_positionals": (lambda m: m._parse_arm_args(
        ["3000", "1e-3", "cosine", "mytag", "mt", "alpha=0.5"], "constant"),
        (3000, 1e-3, "cosine", True, 0.5, ["mytag"])),
    "defaults": (lambda m: m._parse_arm_args([], "cosine"),
                 (3000, 1e-3, "cosine", False, 0.0, [])),
    "alpha_labels": (lambda m: [m._alpha_label(a) for a in (0, 0.5, 0.8)],
                     ["", "a50", "a80"]),
    "alpha_labels_never_collide": (lambda m: (
        m._alpha_label(0.804) != m._alpha_label(0.8),
        m._alpha_label(0.004) not in ("", m._alpha_label(0.0)),
        len({m._alpha_label(a) for a in (0.1, 0.15, 0.2, 0.25, 0.5, 0.55,
                                         0.8, 0.804, 0.85)})),
        (True, True, 9)),
    "with_alpha": (lambda m: (m._with_alpha(None, 0.0),
                              m._with_alpha({"gt_range": (1, 2)}, 0.8),
                              m._with_alpha({"gt_range": (1, 2)}, 0.0)),
                   ({}, {"gt_range": (1, 2), "score_corr": 0.8},
                    {"gt_range": (1, 2)})),
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_arm_helpers_as_the_reference(case):
    call, want = ARG_CASES[case]
    assert call(sd) == want
    assert call(REF) == want
    density = {"gt_range": (1, 2)}
    sd._with_alpha(density, 0.8)
    assert density == {"gt_range": (1, 2)}        # input not mutated


def _record(mod, monkeypatch, data: Path) -> dict:
    """Replaces the generators and the subprocess phases of ``mod`` by
    recorders -> the record they fill."""
    seen = {"gen": [], "phases": []}

    def gen(**kw):
        kw.pop("data_dir", None)
        seen["gen"].append(kw)

    def phase(name, argv, env=None):
        seen["phases"].append(list(argv))
        return {}

    monkeypatch.setattr(mod, "gen", lambda **kw: gen(kind="coco", **kw))
    monkeypatch.setattr(mod, "gen_pets", lambda **kw: gen(kind="pets", **kw))
    monkeypatch.setattr(mod, "_run_phase", phase)
    if mod is REF:
        monkeypatch.setattr(REF, "DATA", data)
    return seen


@pytest.mark.parametrize("argv", [
    ["run"], ["full"], ["full", "3000", "1e-3", "cosine"],
    ["full80", "3000", "1e-3", "cosine", "mytag", "mt", "alpha=0.5"],
    ["dense"], ["dense80", "3000", "1e-3", "cosine", "mt"],
    ["dense4k", "mt", "alpha=0.8"], ["pets"],
    ["pets", "3000", "1e-3", "cosine", "mt", "alpha=0.8"]],
    ids=lambda a: "_".join(a))
def test_arm_yamls_load_to_the_reference_config(tmp_path, monkeypatch, argv):
    """Each arm's command line in both scripts: the same generator calls,
    YAMLs of the same text that load to the same config in both packages,
    and the same CLI phases, the port's naming its own modules and
    ``--device``."""
    ref = _record(REF, monkeypatch, tmp_path)
    monkeypatch.setattr(sys, "argv", ["scale_drill.py", *argv])
    exec(compile(REF_MAIN, str(SCRIPTS / "scale_drill.py"), "exec"),
         REF.__dict__)
    ref_yamls = {p.name: p.read_text() for p in tmp_path.glob("*.yaml")}
    for p in tmp_path.glob("*.yaml"):
        p.unlink()

    port = _record(sd, monkeypatch, tmp_path)
    sd.main([*argv, "--device", "cpu", "--data-dir", str(tmp_path)])
    yamls = {p.name: p.read_text() for p in tmp_path.glob("*.yaml")}

    assert port["gen"] == ref["gen"]
    assert yamls == ref_yamls and yamls
    for name in yamls:
        path = str(tmp_path / name)
        assert dataclasses.asdict(t_load_config(path)) == \
            dataclasses.asdict(j_load_config(path))
    assert port["phases"] == [
        [re.sub(r"^gossipnet_tpu\.", "gossipnet_tpu_torch.", a) for a in p]
        + ["--device", "cpu"] for p in ref["phases"]]
    assert len(port["phases"]) == (5 if argv == ["run"] else 2)


def _small_yamls(monkeypatch):
    """Cuts every YAML the drill writes to one narrow block, buckets of
    64-256, two steps and a validation pass at step 2."""
    real_yaml = sd._yaml

    def small(data_dir, name, text):
        text = re.sub(r"num_blocks: \d+", "num_blocks: 1", text)
        text = re.sub(r"feature_dim: \d+", "feature_dim: 16", text)
        text = re.sub(r"(reduced|pairwise)_dim: \d+", r"\1_dim: 8", text)
        text = text.replace("[256, 512, 1024]", "[64, 128, 256]")
        text = text.replace("[1024, 2048, 4096]", "[64, 128, 256]")
        text = re.sub(r"max_detections: \d+", "max_detections: 256", text)
        text = re.sub(r"max_steps: \d+", "max_steps: 2", text)
        text = text.replace("eval_every: 500", "eval_every: 2")
        return real_yaml(data_dir, name, text)

    monkeypatch.setattr(sd, "_yaml", small)


# the arms' command lines, and their files at a few frames or images,
# written before the arm runs (it then generates none of its own)
ARMS_ON_CPU = {
    "pets_mt": (["pets", "3000", "1e-3", "cosine", "mt"], "pets_mt",
                lambda d: (sd.gen_pets(n_frames=8, data_dir=d),
                           sd.gen_pets(n_frames=4, seed=1, prefix="val_",
                                       data_dir=d))),
    "dense80_mt": (["dense80", "3000", "1e-3", "cosine", "mt"],
                   "dense80_cosine_mt",
                   lambda d: (sd.gen(n_images=4, prefix="dense_",
                                     data_dir=d, **sd.DENSE),
                              sd.gen(n_images=2, seed=1, prefix="dense_val_",
                                     data_dir=d, **sd.DENSE))),
    "dense4k_mt": (["dense4k", "3000", "1e-3", "cosine", "mt"], "dense4k_mt",
                   lambda d: (sd.gen(n_images=2, prefix="dense4k_",
                                     data_dir=d, **sd.DENSE_4K),
                              sd.gen(n_images=2, seed=1,
                                     prefix="dense4k_val_", data_dir=d,
                                     **sd.DENSE_4K))),
}


@pytest.mark.parametrize("arm", ["run", *ARMS_ON_CPU])
def test_run_arm_end_to_end_on_the_cpu(tmp_path, monkeypatch, arm):
    """An arm through the port's train and evaluate CLIs from files that
    the drill's generators wrote, each a subprocess, with the arm's YAMLs
    cut to one narrow block, buckets of 64-256 and two steps: ``run``
    (configs 1-3), and the ``pets``, ``dense80`` and ``dense4k`` arms'
    ``mt`` recipes (PETS files; class-aware T=10 matching; the dense4k
    arm's batch of 2), which evaluate with the swept-GreedyNMS baseline
    (``pets`` its best checkpoint)."""
    _small_yamls(monkeypatch)
    if arm != "run":
        argv, tag, write = ARMS_ON_CPU[arm]
        write(tmp_path)
        out = sd.main([*argv, "--device", "cpu", "--data-dir",
                       str(tmp_path)])
        assert list(out) == [f"{tag}_train", f"{tag}_eval"]
        for rec in out.values():
            assert rec["wall_s"] > 0 and rec["peak_rss_gb"] > 0
            assert rec["built"] == []
        stats = out[f"{tag}_eval"]["result"]
        assert list(stats) == ["gossipnet", "raw_scores", "greedy_nms"]
        for block in stats.values():
            assert all(np.isfinite(v) for v in block.values())
            assert 0.0 <= block["AP"] <= 1.0
        assert stats["raw_scores"]["AP"] > 0.0
        assert stats["greedy_nms"]["iou_threshold"] in [
            float(t) for t in np.arange(0.3, 0.75, 0.05)]
        metrics = [json.loads(x) for x in
                   (tmp_path / f"m_{tag}.jsonl").read_text().splitlines()]
        assert [m["step"] for m in metrics if "val_AP" in m] == [2]
        restored = ("restored best-AP checkpoint (step 2)" if arm == "pets_mt"
                    else "restored step 2")
        assert restored in "\n".join(out[f"{tag}_eval"]["tail"])
        return
    sd.gen(n_images=16, data_dir=tmp_path)
    out = sd.run(train_steps=2, device="cpu", data_dir=tmp_path)
    assert list(out) == ["config1_eval_persons", "config2_train_persons",
                         "config2_eval", "config3_train_80cls",
                         "config3_eval"]
    for rec in out.values():
        assert rec["wall_s"] > 0 and rec["peak_rss_gb"] > 0
        assert rec["built"] == []
    for ck in ("ck2", "ck3"):
        assert (tmp_path / ck / "steps" / "2.pt").exists()
    for phase in ("config2_eval", "config3_eval"):
        text = "\n".join(out[phase]["tail"])
        stats = json.loads(text[text.index("{"):])
        assert 0.0 <= stats["gossipnet"]["AP"] <= 1.0
        assert stats["raw_scores"]["AP"] > 0.0
        assert out[phase]["result"] == stats
    assert "restored step 2" in "\n".join(out["config2_eval"]["tail"])


@pytest.mark.parametrize("arm", ["run", "all", "full80", "pets", "dense4k"])
def test_arms_that_train_raise_without_a_card_before_generating(tmp_path,
                                                                 arm):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.main([arm, "--data-dir", str(tmp_path / "data")])
    assert not (tmp_path / "data").exists()


def test_run_phase_reports_the_childs_own_peak_rss():
    """A phase that holds ~100 MB under a drill that holds ~300 MB reports
    its own peak: forked from the drill itself, wait4's ru_maxrss would
    carry the drill's resident set over the fork (at least 0.3 GB)."""
    held = np.ones(300_000_000 // 8)
    rec = sd._run_phase("rss", [sys.executable, "-c", (
        "import numpy as np; a = np.ones(100_000_000 // 8)")])
    assert 0.1 <= rec["peak_rss_gb"] < 0.25
    assert held.sum() == len(held)


def test_run_phase_raises_when_a_phase_fails(capsys):
    with pytest.raises(SystemExit, match="broken failed"):
        sd._run_phase("broken", [sys.executable, "-c", "raise SystemExit(3)"])
    assert "--- broken: FAILED" in capsys.readouterr().out


def test_eval5k_equals_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(REF, "DATA", tmp_path)
    REF.gen(n_images=40)
    capsys.readouterr()
    REF.eval5k()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = sd.eval5k(tmp_path)
    assert {k: got[k] for k in ("images", "AP", "AP50", "numpy_fallback")} \
        == {k: want[k] for k in ("images", "AP", "AP50", "numpy_fallback")}
    assert got["AP"] > 0


def test_data_dir_is_in_the_checkout_or_the_cache(tmp_path):
    assert sd.DATA == Path(sd.__file__).resolve().parents[2] / "data" / \
        "scale_drill_torch"
    pkg = tmp_path / "site-packages" / "gossipnet_tpu_torch"
    assert sd.default_data_dir(pkg, {"XDG_CACHE_HOME": str(tmp_path / "c")}) \
        == tmp_path / "c" / "gossipnet_tpu_torch" / "scale_drill"
    assert "data/scale_drill_torch/" in (
        Path(sd.__file__).resolve().parents[2] / ".gitignore").read_text()


@pytest.mark.parametrize("person_only", [False, True])
def test_convert_equals_the_reference(tmp_path, person_only):
    """The port's NPZ equals the reference's array by array, and the port's
    loader reads it: with persons only, to the same records as the JSON."""
    sd.gen(n_images=12, data_dir=tmp_path)
    dets = str(tmp_path / "detections.json")
    flag = ["--person-only"] if person_only else []
    REF_PD.cmd_convert(argparse.Namespace(
        dets=dets, out=str(tmp_path / "ref.npz"), person_only=person_only))
    prepare_data.main(["convert", "--dets", dets,
                       "--out", str(tmp_path / "port.npz"), *flag])
    ref, port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert sorted(port.files) == sorted(ref.files)
    for key in ref.files:
        assert port[key].dtype == ref[key].dtype
        assert np.array_equal(port[key], ref[key]), key
    ann = str(tmp_path / "annotations.json")
    from_npz = build_roidb(ann, str(tmp_path / "port.npz"),
                           person_only=person_only)
    assert sum(r.num_dets for r in from_npz) == len(port["scores"])
    if person_only:
        from_json = build_roidb(ann, dets, person_only=True)
        assert len(from_npz) == len(from_json)
        for a, b in zip(from_npz, from_json):
            assert a.image_id == b.image_id
            np.testing.assert_allclose(a.det_boxes, b.det_boxes, rtol=1e-6)
            np.testing.assert_array_equal(a.det_scores, b.det_scores)
            np.testing.assert_array_equal(a.det_classes, b.det_classes)


def test_prepare_data_detect_is_not_ported(capsys):
    prepare_data.main(["download"])
    assert "annotations_trainval2014.zip" in capsys.readouterr().out
    for argv in (["detect"], ["detect", "--images", "x", "--out", "y"]):
        with pytest.raises(SystemExit, match="not ported"):
            prepare_data.main(argv)


# ---------------------------------------------------------------------------
# The remaining arms' gate (chip_smoke.py --drill-arm) and their paths
# ---------------------------------------------------------------------------

STATS = ("AP", "AP50", "AP75", "AR100", "APs", "APm", "APl", "AR1", "AR10")


def _eval_record(raw=0.29312, nms=0.36391, thr=0.55, gossipnet=0.6804,
                 extra=0):
    """An evaluate CLI's record (its keys; ``extra`` more stats a block)."""
    def block(ap):
        out = {k: ap + 0.01 * i for i, k in enumerate(STATS)}
        out.update({f"x{i}": 0.5 for i in range(extra)})
        return out

    return {"gossipnet": block(gossipnet), "raw_scores": block(raw),
            "greedy_nms": {"iou_threshold": thr, **block(nms)}}


def test_run_phase_hands_back_the_whole_final_record():
    """A phase whose record starts more than 40 lines before the end of its
    output: the tail has lost the ``gossipnet`` block, the phase's
    ``result`` holds the whole record, and a log line after a record does
    not displace it."""
    record = _eval_record(extra=6)
    assert len(json.dumps(record, indent=2).splitlines()) > 40
    code = ("import json, sys; print('step 100 loss=0.5'); "
            "print('{not json'); "
            f"print(json.dumps(json.loads({json.dumps(record)!r}), "
            "indent=2))")
    rec = sd._run_phase("eval", [sys.executable, "-c", code])
    assert '"gossipnet": {' not in "\n".join(rec["tail"])
    assert rec["result"] == record
    assert sd.last_json("{\"a\": 1}\n{\"b\": [1,\n  2]}\ndone\n{oops") == \
        {"b": [1, 2]}
    assert sd.last_json("no record here") is None


def test_drill_gate_reads_the_evaluate_clis_record(tmp_path):
    """The gate's parser on a real evaluate CLI record (the CPU, a seeded
    random model, the sweep): every block is read, whatever the tail."""
    import chip_smoke

    sd.gen(n_images=4, data_dir=tmp_path)
    y = sd.full_yaml(tag="g", data_dir=tmp_path)
    text = re.sub(r"num_blocks: \d+", "num_blocks: 1", Path(y).read_text())
    Path(y).write_text(text)
    rec = sd._run_phase("eval", [sys.executable, "-m",
                                 "gossipnet_tpu_torch.evaluate", "-c", y,
                                 "--random-init", "--nms-sweep",
                                 "--device", "cpu"])
    lines, held = chip_smoke.drill_gate(
        chip_smoke.DRILL_REFERENCE[("dense", "cosine", True)],
        rec["result"])
    assert len(lines) == 5 and not held
    assert f"{rec['result']['gossipnet']['AP']:.7f}" in lines[-1]


@pytest.mark.parametrize("change,held", [
    ({}, True), ({"raw": 0.29212}, False), ({"raw": 0.29349}, True),
    ({"nms": 0.36451}, False), ({"thr": 0.6}, False),
    ({"thr": 0.3 + 5 * 0.05}, True), ({"gossipnet": 0.6960}, True),
    ({"gossipnet": 0.6575}, True), ({"gossipnet": 0.6565}, False),
    ({"gossipnet": 0.6975}, False)],
    ids=["equal", "raw_third_digit", "raw_rounds_equal", "nms_third_digit",
         "other_threshold", "swept_threshold", "gossipnet_above_in_band",
         "gossipnet_below_in_band", "gossipnet_below_band",
         "gossipnet_above_band"])
def test_drill_gate(change, held):
    """Both baselines must round to the reference's three printed digits
    (GreedyNMS at the same swept threshold) and GossipNet's AP must lie
    within 0.02 of the reference's (``dense 3000 1e-3 cosine mt``: 0.293,
    0.364 at 0.55, 0.677)."""
    import chip_smoke

    lines, ok = chip_smoke.drill_gate(
        chip_smoke.DRILL_REFERENCE[("dense", "cosine", True)],
        _eval_record(**change))
    assert ok is held
    assert len(lines) == 5 and lines[-1].endswith(
        "| yes |" if change.get("gossipnet", 0.68) < 0.697
        and change.get("gossipnet", 0.68) > 0.657 else "| NO |")


def _results_row(n: int) -> list:
    """The AP, AP50 and AP75 cells of RESULTS.md's line ``n`` (None for a
    dash)."""
    cells = [c.strip().strip("*") for c in RESULTS[n - 1].split("|")[2:5]]
    return [None if c in ("—", "-") else float(c) for c in cells]


RESULTS = (Path(__file__).resolve().parents[1] / "RESULTS.md").read_text(
    ).splitlines()


def test_drill_reference_figures_are_results_md():
    """Every figure the gate holds a recipe to is the cell of the
    RESULTS.md line it cites: the raw row, the swept-GreedyNMS row (its
    best threshold) and the recipe's GossipNet row."""
    import chip_smoke

    assert len(chip_smoke.DRILL_REFERENCE) == 8
    for key, ref in chip_smoke.DRILL_REFERENCE.items():
        lines = []
        for part in ref["lines"].split(", "):
            a, _, b = part.partition("-")
            lines += list(range(int(a), int(b or a) + 1))
        raw, nms, gossipnet = lines[0], lines[1], lines[-1]
        assert _results_row(raw) == list(ref["raw"]), key
        assert _results_row(nms) == list(ref["nms"]), key
        assert f"best {ref['thr']:.2f}" in RESULTS[nms - 1], key
        assert _results_row(gossipnet) == list(ref["gossipnet"]), key


@pytest.mark.parametrize("argv,key", [
    (["dense4k", "3000", "1e-3", "cosine", "mt"], ("dense4k", "cosine", True)),
    (["pets", "mt"], ("pets", "cosine", True)),
    (["dense"], ("dense", "constant", False)),
    (["dense80", "3000", "1e-3", "cosine"], ("dense80", "cosine", False)),
    (["dense", "300", "1e-3", "cosine"], None),
    (["dense4k", "3000", "1e-3", "cosine"], None),
    (["pets", "3000", "1e-3", "cosine", "mt", "alpha=0.8"], None),
    (["full"], None)],
    ids=["dense4k_mt", "pets_defaults", "dense_defaults", "dense80",
         "other_steps", "no_figures", "alpha", "other_arm"])
def test_drill_recipe(argv, key):
    import chip_smoke

    if key is None:
        with pytest.raises(SystemExit):
            chip_smoke.drill_recipe(argv)
    else:
        assert chip_smoke.drill_recipe(argv) == key


@pytest.mark.parametrize("arm", ["dense80_mt", "dense_constant"])
def test_dense80_t10_class_aware_labels_equal_the_jax_packages(tmp_path,
                                                               arm):
    """One N=1024 batch of the dense80 arm's files, matched at the ``mt``
    recipe's ten thresholds within classes (and of the persons-only dense
    arm's files at the constant recipe's one threshold): the port's scan
    and K3's plain version give the JAX package's labels, ignore and
    matched GT exactly."""
    import jax.numpy as jnp
    import torch

    from gossipnet_tpu.ops.matching import greedy_match_batch as j_match
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.ops import matching as tm

    mc = arm == "dense80_mt"
    sd.gen(n_images=3, prefix="dense_", data_dir=tmp_path,
           **(sd.DENSE if mc else sd.DENSE_P))
    cfg = t_load_config(sd.full_yaml(
        schedule="cosine" if mc else "constant", tag="t", multiclass=mc,
        prefix="dense_", mt=mc, data_dir=tmp_path))
    roidb = build_roidb(cfg.data.ann_file, cfg.data.det_file,
                        person_only=cfg.data.person_only,
                        max_dets=cfg.data.max_detections)
    it = BatchIterator(roidb, 2, cfg.data.bucket_sizes, seed=cfg.train.seed)
    batch = next(b for b in it if b.padded_n == 1024)
    thr = np.asarray(cfg.matching.thresholds, np.float32)
    assert len(thr) == (10 if mc else 1) and cfg.matching.class_aware == mc
    assert roidb.num_classes == (80 if mc else 1)
    scores = np.random.default_rng(0).normal(
        size=batch.scores.shape).astype(np.float32)
    arrays = (batch.boxes, scores, batch.valid, batch.gt_boxes,
              batch.gt_valid, batch.gt_crowd)
    classes = (batch.classes, batch.gt_classes) if mc else (None, None)
    want = j_match(*map(jnp.asarray, arrays), jnp.asarray(thr),
                   *(None if c is None else jnp.asarray(c) for c in classes),
                   impl="scan")
    for impl in ("scan", "kernel"):
        got = tm.greedy_match_batch(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays),
            torch.from_numpy(thr),
            *(None if c is None else torch.from_numpy(np.ascontiguousarray(c))
              for c in classes), impl=impl)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want.labels).sum() > 0


def test_drill_arm_train_seed_reaches_the_yaml(tmp_path):
    """``--drill-arm ... --train-seed N`` writes ``train.seed: N`` into the
    arm's YAML and nothing else; without it the YAML is the recipe's."""
    import chip_smoke

    plain = Path(sd.full_yaml(tag="a", data_dir=tmp_path)).read_text()
    with chip_smoke.train_seed(2):
        seeded = Path(sd.full_yaml(tag="a", data_dir=tmp_path)).read_text()
    assert Path(sd.full_yaml(tag="a", data_dir=tmp_path)).read_text() == plain
    assert seeded.replace("seed: 2, ", "") == plain
    assert t_load_config(str(tmp_path / "cfg_a.yaml")).train.seed == 0
    (tmp_path / "s.yaml").write_text(seeded)
    assert t_load_config(str(tmp_path / "s.yaml")).train.seed == 2
    argv = ["dense", "--train-seed", "1", "constant"]
    assert chip_smoke.pop_option(argv, "--train-seed") == "1"
    assert chip_smoke.pop_option(argv, "--seed") is None
    assert argv == ["dense", "constant"]
