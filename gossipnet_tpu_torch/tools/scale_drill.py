"""The scale drill: configs 1-3 end to end from real-format files (the
port's counterpart of ``scripts/scale_drill.py``).

    python -m gossipnet_tpu_torch.tools.scale_drill [ARM] [ARGS] \\
        [--device cuda|cpu] [--data-dir DIR]

Arms:

- ``gen``: writes a real-format dataset: COCO annotations JSON (5k
  images, 80 non-contiguous COCO category ids, 4% crowds) and a
  COCO-results detections JSON (~75 detections an image, jittered around
  the ground truth like a detector's dump, person-heavy category mix).
  The numpy code is the reference's line for line: the same seed writes
  the same bytes.
- ``eval5k``: the numpy COCOEvaluator over the 5k images (< 60 s).
- ``run``: configs 1-3 through the CLIs against those files: config-1
  evaluation (persons, 1 block), config-2 training (300 steps) and its
  evaluation, config-3 training (80 classes) and its evaluation. Each
  phase is a subprocess; its wall time and peak RSS print as JSON.
- ``all`` (the default): ``gen``, ``eval5k``, ``run``.
- ``full|full80 [steps] [lr] [schedule] [tag] [mt] [alpha=X]``: config 2
  (or 3) for the full budget with a held-out validation split and the best
  checkpoint, then the evaluation with the swept-GreedyNMS baseline;
  ``pets [steps] [lr] [schedule] [mt] [alpha=X]``: the same on PETS
  files (CVML XML ground truth, MOT-CSV detections); ``dense|dense80``
  and ``dense4k``: at the reference's detection density (N=1024 and
  N=4096 buckets).

The arms that train or evaluate run on the card (``--device cuda``, the
default) and raise without one before they generate anything; ``--device
cpu`` runs the plain path. ``gen`` and ``eval5k`` run on the host alone.
Files go to ``data/scale_drill_torch/`` of the checkout (outside a
checkout, beside the kernels' build directory in the user's cache);
``--data-dir`` overrides it. The CLI phases read the kernels that the
drill builds before the first of them starts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from gossipnet_tpu_torch.ops.cuda import build

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
N_IMAGES = 5000
CANVAS_W, CANVAS_H = 640, 480
# the kernels of the drill's configs: K1 and K2 (pair_kernel 2), K3
KERNELS = ("pairwise2_fwd", "pairwise2_bwd", "matching_scan")
ARMS = ("gen", "eval5k", "run", "all", "full", "full80", "pets", "dense",
        "dense80", "dense4k")


def default_data_dir(package_dir: Path = PACKAGE, environ=os.environ) -> Path:
    """``data/scale_drill_torch`` of the checkout around ``package_dir``;
    outside a checkout ``scale_drill`` beside the kernels' build directory
    (``build.default_build_dir``)."""
    if (package_dir.parent / "pyproject.toml").is_file():
        return package_dir.parent / "data" / "scale_drill_torch"
    return build.default_build_dir(package_dir, environ).parent / "scale_drill"


DATA = default_data_dir()

# COCO-like category mix: person (id 1) ~30% of instances, the rest
# spread over 79 other ids (real COCO ids are non-contiguous; use a
# representative non-contiguous id set to exercise the remapping).
CAT_IDS = [1] + [i for i in range(2, 91) if i not in
                 (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)][:79]


def _max_iou_same_cat_many(dets, det_cats, gts):
    """Per-det max IoU (xywh boxes) vs an image's same-category GTs.

    ``dets`` [D][4], ``det_cats`` [D], ``gts`` list of (cid, xywh) ->
    [D] float64. Every surviving pair evaluates the same f64 expression
    chain as a per-(det, GT) loop, masked pairs contribute 0.0, and max
    is exact."""
    D = len(dets)
    if D == 0 or len(gts) == 0:
        return np.zeros(D)
    d = np.asarray(dets, np.float64).reshape(D, 4)
    g = np.asarray([b for _, b in gts], np.float64).reshape(len(gts), 4)
    cat_ok = (np.asarray(det_cats)[:, None]
              == np.asarray([c for c, _ in gts])[None, :])
    ix = (np.minimum((d[:, 0] + d[:, 2])[:, None],
                     (g[:, 0] + g[:, 2])[None, :])
          - np.maximum(d[:, 0][:, None], g[:, 0][None, :]))
    iy = (np.minimum((d[:, 1] + d[:, 3])[:, None],
                     (g[:, 1] + g[:, 3])[None, :])
          - np.maximum(d[:, 1][:, None], g[:, 1][None, :]))
    inter = ix * iy
    u = ((d[:, 2] * d[:, 3])[:, None]
         + (g[:, 2] * g[:, 3])[None, :] - inter)
    ok = (ix > 0) & (iy > 0) & (u > 0) & cat_ok
    # guard the masked lanes so the division never raises, then zero them
    iou = np.where(ok, inter, 0.0) / np.where(ok, u, 1.0)
    return iou.max(axis=1, initial=0.0)


def gen(n_images=N_IMAGES, seed=0, prefix="",
        gt_range=(2, 22), dets_per_gt=(3, 8), fp_range=(10, 30),
        person_p=0.3, score_corr=0.0, data_dir: Path = DATA) -> dict:
    """Writes ``{prefix}annotations.json`` and ``{prefix}detections.json``
    to ``data_dir`` -> the counts of images, annotations and detections.

    score_corr (alpha) blends detector scores with localization quality:
    score = clip(alpha*maxIoU(det, same-cat GT) + (1-alpha)*noise). The
    rng draw sequence does not depend on alpha, and alpha=0 gives the
    noise scores themselves."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cat_p = np.full(len(CAT_IDS), (1.0 - person_p) / (len(CAT_IDS) - 1))
    cat_p[0] = person_p

    images, annotations, detections = [], [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "width": CANVAS_W,
                       "height": CANVAS_H,
                       "file_name": f"drill_{img_id:06d}.jpg"})
        n_gt = int(rng.integers(*gt_range))
        img_gts = []          # (cid, xywh) incl. crowds
        pending = []          # (cid, xywh bbox, raw noise) dets
        for _ in range(n_gt):
            cid = int(rng.choice(CAT_IDS, p=cat_p))
            w = float(rng.uniform(12, 200)); h = float(rng.uniform(12, 200))
            x = float(rng.uniform(0, CANVAS_W - w))
            y = float(rng.uniform(0, CANVAS_H - h))
            crowd = int(rng.uniform() < 0.04)
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cid,
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": crowd,
            })
            ann_id += 1
            img_gts.append((cid, [x, y, w, h]))
            # detector dump: jittered dets per (non-crowd) GT; scores
            # finalize at image end, when all GTs are known
            if not crowd:
                for _ in range(int(rng.integers(*dets_per_gt))):
                    jit = rng.normal(0, 0.12 * min(w, h), size=4)
                    bw = max(w + jit[2], 4.0); bh = max(h + jit[3], 4.0)
                    pending.append((cid, [x + jit[0], y + jit[1], bw, bh],
                                    float(rng.normal(0.55, 0.22))))
        # background false positives
        for _ in range(int(rng.integers(*fp_range))):
            cid = int(rng.choice(CAT_IDS, p=cat_p))
            w = float(rng.uniform(12, 160)); h = float(rng.uniform(12, 160))
            pending.append((cid,
                            [float(rng.uniform(0, CANVAS_W - w)),
                             float(rng.uniform(0, CANVAS_H - h)), w, h],
                            float(rng.normal(0.35, 0.2))))
        qs = (_max_iou_same_cat_many([b for _, b, _ in pending],
                                     [c for c, _, _ in pending], img_gts)
              if score_corr else np.zeros(len(pending)))
        for (cid, bbox, noise), q in zip(pending, qs):
            detections.append({
                "image_id": img_id, "category_id": cid,
                "bbox": bbox,
                "score": float(np.clip(
                    score_corr * q + (1.0 - score_corr) * noise,
                    0.01, 0.999)),
            })

    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"cat_{c}" if c != 1 else "person",
                        "supercategory": "drill"} for c in CAT_IDS],
    }
    (data_dir / f"{prefix}annotations.json").write_text(json.dumps(ann))
    (data_dir / f"{prefix}detections.json").write_text(json.dumps(detections))
    print(f"gen: {n_images} images, {len(annotations)} anns, "
          f"{len(detections)} dets -> {data_dir}/{prefix}*", flush=True)
    return {"images": n_images, "annotations": len(annotations),
            "detections": len(detections)}


def _yaml(data_dir: Path, name: str, text: str) -> str:
    p = Path(data_dir) / name
    p.write_text(text)
    return str(p)


def _libraries() -> set:
    return set(build.BUILD_DIR.glob("lib*.so"))


# Runs argv[2:] as its own child, writes that child's ru_maxrss (KiB) to
# argv[1] and exits with its code. The phase is forked from this small
# process, so its ru_maxrss is its own: Linux carries the image a child
# replaces at execve into the child's ru_maxrss, and a phase forked from
# the drill itself would report at least the drill's resident set.
_MEASURED = ("import os, subprocess, sys; p = subprocess.Popen(sys.argv[2:]); "
             "_, status, ru = os.wait4(p.pid, 0); "
             "open(sys.argv[1], 'w').write(str(ru.ru_maxrss)); "
             "sys.exit(os.waitstatus_to_exitcode(status))")


def _run_phase(name: str, argv: list[str], env=None) -> dict:
    """Runs one CLI phase as a subprocess -> its wall time, its own peak
    RSS (``os.wait4`` of the phase, forked from a small launcher:
    ``_MEASURED``), the kernel libraries it had to build (none when the
    drill built them first) and the end of its output; raises SystemExit
    when it fails."""
    t0 = time.monotonic()
    before = _libraries()
    with tempfile.TemporaryDirectory() as tmp:
        rss_file = Path(tmp) / "maxrss"
        proc = subprocess.Popen(
            [sys.executable, "-c", _MEASURED, str(rss_file), *argv],
            cwd=ROOT, env=env or os.environ.copy(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        out = proc.stdout.read()
        _, status, _ = os.wait4(proc.pid, 0)
        proc.wait()
        rss = int(rss_file.read_text()) if rss_file.exists() else 0  # KiB
    wall = time.monotonic() - t0
    ok = os.waitstatus_to_exitcode(status) == 0
    built = sorted(p.name for p in _libraries() - before)
    tail = "\n".join(out.splitlines()[-12:])
    print(f"--- {name}: {'ok' if ok else 'FAILED'} wall={wall:.1f}s "
          f"peak_rss={rss/1e6:.2f}GB built={built}\n{tail if not ok else ''}",
          flush=True)
    if not ok:
        raise SystemExit(f"{name} failed")
    return {"wall_s": round(wall, 1), "peak_rss_gb": round(rss / 1e6, 2),
            "built": built, "tail": out.splitlines()[-40:],
            "result": last_json(out)}


def last_json(text: str):
    """The last JSON object of ``text`` that starts a line of its own (the
    evaluate CLI's indented record, a logger's line) -> it, or None. A
    phase's tail keeps 40 lines, fewer than the evaluate CLI's record with
    the sweep's baseline."""
    lines = text.splitlines()
    for i in reversed(range(len(lines))):
        if lines[i].startswith("{"):
            try:
                obj, _ = json.JSONDecoder().raw_decode("\n".join(lines[i:]))
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict):
                return obj
    return None


def _prebuild(device: str) -> None:
    """On the card, builds the drill's kernels (one nvcc each, at once)
    before the first CLI phase starts, so every phase loads the same
    cached libraries."""
    if device.split(":")[0] != "cuda":
        return
    t0 = time.perf_counter()
    build.build(KERNELS)
    print(f"kernels {', '.join(KERNELS)} in {build.BUILD_DIR} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _cli(module: str, device: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"gossipnet_tpu_torch.{module}", *args,
            "--device", device]


def run_yamls(train_steps=300, data_dir: Path = DATA) -> tuple[str, str, str]:
    """Writes the ``run`` arm's configs 1-3 (``cfg1.yaml``, ``cfg2.yaml``,
    ``cfg3.yaml``) -> their paths."""
    data_dir = Path(data_dir)
    ann = str(data_dir / "annotations.json")
    det = str(data_dir / "detections.json")
    common_data = (
        f"data:\n  dataset: coco\n  ann_file: {ann}\n  det_file: {det}\n"
        "  max_detections: 1024\n  bucket_sizes: [256, 512, 1024]\n"
    )
    y1 = _yaml(data_dir, "cfg1.yaml", (
        "model: {num_blocks: 1, feature_dim: 128, reduced_dim: 32, "
        "pairwise_dim: 32, num_classes: 1}\n"
        f"{common_data}  person_only: true\n"
        f"train: {{batch_size: 8, checkpoint_dir: {data_dir}/ck1}}\n"
    ))
    y2 = _yaml(data_dir, "cfg2.yaml", (
        "model: {num_blocks: 16, feature_dim: 128, reduced_dim: 32, "
        "pairwise_dim: 32, num_classes: 1}\n"
        "matching: {thresholds: [0.5], crowd_as_ignore: true}\n"
        f"{common_data}  person_only: true\n"
        "train: {optimizer: adam, learning_rate: 1.0e-4, "
        f"max_steps: {train_steps}, batch_size: 8, grad_clip_norm: 10.0, "
        "snapshot_every: 0, eval_every: 0, log_every: 100, "
        f"checkpoint_dir: {data_dir}/ck2}}\n"
    ))
    y3 = _yaml(data_dir, "cfg3.yaml", (
        "model: {num_blocks: 16, feature_dim: 128, reduced_dim: 32, "
        "pairwise_dim: 32, num_classes: 80, class_embed_dim: 32}\n"
        "matching: {thresholds: [0.5], class_aware: true}\n"
        f"{common_data}  person_only: false\n"
        "train: {optimizer: adam, learning_rate: 1.0e-4, "
        f"max_steps: {max(train_steps * 2 // 3, 100)}, batch_size: 8, "
        "grad_clip_norm: 10.0, snapshot_every: 0, eval_every: 0, "
        f"log_every: 100, checkpoint_dir: {data_dir}/ck3}}\n"
    ))
    return y1, y2, y3


def run(train_steps=300, device="cuda", data_dir: Path = DATA) -> dict:
    """Configs 1-3 through the train and evaluate CLIs on the files of
    ``gen`` in ``data_dir`` -> each phase's record."""
    data_dir = Path(data_dir)
    y1, y2, y3 = run_yamls(train_steps, data_dir)
    _prebuild(device)
    out = {
        "config1_eval_persons": _run_phase(
            "config-1 eval (persons, 1-block, 5k images)",
            _cli("evaluate", device, "-c", y1)),
        "config2_train_persons": _run_phase(
            f"config-2 train (persons, 16-block, {train_steps} steps)",
            _cli("train", device, "-c", y2,
                 "--metrics", str(data_dir / "m2.jsonl"))),
        "config2_eval": _run_phase(
            "config-2 eval (trained ckpt, 5k images)",
            _cli("evaluate", device, "-c", y2)),
        "config3_train_80cls": _run_phase(
            "config-3 train (80-class, 16-block)",
            _cli("train", device, "-c", y3,
                 "--metrics", str(data_dir / "m3.jsonl"))),
        "config3_eval": _run_phase(
            "config-3 eval (80-class, 5k images)",
            _cli("evaluate", device, "-c", y3)),
    }
    print(json.dumps(out), flush=True)
    return out


# Reference detection density (SURVEY §5 long-context note): hundreds
# to 1024 dets/image, N=1024 bucket dominant. ~50x11 GT-clustered dets
# + ~140 background FPs => mean ~690/image, tail above the 1024 cap.
DENSE = dict(gt_range=(30, 71), dets_per_gt=(8, 15), fp_range=(80, 201))
# Persons arm: person_only filters to category 1, so the density must
# land AFTER filtering — person-dominant mix + higher dets/GT keeps the
# per-image PERSON count in the 1024 bucket (~700 mean).
DENSE_P = dict(gt_range=(30, 71), dets_per_gt=(10, 17),
               fp_range=(80, 201), person_p=0.95)
# Config-4 regime: thousands of detections/image so the N=4096 bucket
# dominates TRAINING. ~170 GT x ~13.5 dets + ~300 FPs => mean ~2600
# person dets/image, tail above the 4096 cap.
DENSE_4K = dict(gt_range=(120, 221), dets_per_gt=(10, 17),
                fp_range=(200, 401), person_p=0.95)
# the dense4k arm's batch and buckets (config 4's N=4096 regime)
DENSE_4K_ARM = dict(batch_size=2, buckets="[1024, 2048, 4096]",
                    max_dets=4096)
# the `mt` arms' matching thresholds, COCO's 0.5:0.95
MT_THRESHOLDS = "[0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]"


def full_yaml(train_steps=3000, lr=1e-3, schedule="constant", tag="full",
              multiclass=False, prefix="", mt=False, batch_size=8,
              buckets="[256, 512, 1024]", max_dets=1024,
              data_dir: Path = DATA) -> str:
    """Writes ``cfg_{tag}.yaml`` of the ``full`` arm and the arms built on
    it (``full80``, ``dense``, ``dense80``, ``dense4k``): config 2 (or,
    ``multiclass``, config 3) on ``{prefix}`` files with their held-out
    ``{prefix}val_`` split -> its path."""
    data_dir = Path(data_dir)
    ann = str(data_dir / f"{prefix}annotations.json")
    det = str(data_dir / f"{prefix}detections.json")
    ck = data_dir / f"ck_{tag}"
    # COCO-style multi-threshold matching (0.5:0.95); `mt` runs the same
    # labels at reference density.
    thr = MT_THRESHOLDS if mt else "[0.5]"
    model = ("model: {num_blocks: 16, feature_dim: 128, reduced_dim: 32, "
             "pairwise_dim: 32, num_classes: 80, class_embed_dim: 32}\n"
             f"matching: {{thresholds: {thr}, class_aware: true, "
             "crowd_as_ignore: true}\n" if multiclass else
             "model: {num_blocks: 16, feature_dim: 128, reduced_dim: 32, "
             "pairwise_dim: 32, num_classes: 1}\n"
             f"matching: {{thresholds: {thr}, crowd_as_ignore: true}}\n")
    return _yaml(data_dir, f"cfg_{tag}.yaml", (
        model
        + f"data:\n  dataset: coco\n  ann_file: {ann}\n  det_file: {det}\n"
        f"  val_ann_file: {data_dir / (prefix + 'val_annotations.json')}\n"
        f"  val_det_file: {data_dir / (prefix + 'val_detections.json')}\n"
        f"  max_detections: {max_dets}\n  bucket_sizes: {buckets}\n"
        f"  person_only: {'false' if multiclass else 'true'}\n"
        f"train: {{optimizer: adam, learning_rate: {lr}, "
        f"lr_schedule: {schedule}, "
        f"max_steps: {train_steps}, batch_size: {batch_size}, "
        "grad_clip_norm: 10.0, "
        "snapshot_every: 1000, eval_every: 500, log_every: 100, "
        f"checkpoint_dir: {ck}}}\n"
    ))


def full(train_steps=3000, lr=1e-3, schedule="constant", tag="full",
         multiclass=False, prefix="", n_images=N_IMAGES, density=None,
         mt=False, batch_size=8, buckets="[256, 512, 1024]",
         max_dets=1024, device="cuda", data_dir: Path = DATA) -> dict:
    """Full-budget config-2 (or, ``multiclass``, config-3) training on the
    drill dataset: ``train_steps`` with a held-out val split (n_images/8
    images, seed 1) driving periodic val-AP evaluation and the best-AP
    checkpoint through the train CLI, then the evaluate CLI on the
    ``n_images`` train-distribution images with the swept-GreedyNMS
    baseline. One JSON line per phase."""
    data_dir = Path(data_dir)
    density = density or {}
    if not (data_dir / f"{prefix}annotations.json").exists():
        gen(n_images=n_images, prefix=prefix, data_dir=data_dir, **density)
    if not (data_dir / f"{prefix}val_annotations.json").exists():
        gen(n_images=max(n_images // 8, 100), seed=1,
            prefix=f"{prefix}val_", data_dir=data_dir, **density)
    y = full_yaml(train_steps, lr, schedule, tag, multiclass, prefix, mt,
                  batch_size, buckets, max_dets, data_dir)
    _prebuild(device)
    out = {
        f"{tag}_train": _run_phase(
            f"{tag} train ({train_steps} steps, lr={lr}, {schedule})",
            _cli("train", device, "-c", y,
                 "--metrics", str(data_dir / f"m_{tag}.jsonl"))),
        f"{tag}_eval": _run_phase(
            f"{tag} eval ({n_images} train-dist images, swept-NMS baseline)",
            _cli("evaluate", device, "-c", y, "--nms-sweep")),
    }
    print(json.dumps(out), flush=True)
    return out


def gen_pets(n_frames=800, seed=0, prefix="", score_corr=0.0,
             data_dir: Path = DATA) -> dict:
    """Real-format PETS files: CVML XML ground truth (0-based frames,
    center-form boxes — the PETS2009 distribution schema) + MOT-style
    CSV detections (1-based frames, top-left boxes), which the PETS
    loader realigns. Crowd statistics follow the PETS surveillance
    regime: 768x576 frames, 15-55 pedestrians partly in occluding rows,
    4-9 jittered detections per person, plus background false positives.

    score_corr (alpha) blends detector scores with localization quality
    exactly like ``gen``; the rng draw sequence does not depend on it.
    -> the counts of frames and detection rows."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    W, H = 768, 576
    xml = ['<dataset name="drill_pets">']
    csv = []
    for fr in range(n_frames):
        xml.append(f'  <frame number="{fr}">\n    <objectlist>')
        n_people = int(rng.integers(15, 56))
        placed = 0
        oid = 0
        frame_gts = []   # (cat, xywh) for _max_iou_same_cat_many
        pending = []     # (xywh bbox, raw noise) dets, frame order
        while placed < n_people:
            # occlusion row: 2-6 people shoulder-to-shoulder
            row = min(int(rng.integers(2, 7)), n_people - placed)
            w = float(rng.uniform(24, 44))
            h = float(rng.uniform(58, 112))
            xc = float(rng.uniform(w, W - row * 0.55 * w - w))
            yc = float(rng.uniform(h / 2 + 2, H - h / 2 - 2))
            for k in range(row):
                cx = xc + k * 0.55 * w   # ~0.45 width overlap
                cy = yc + float(rng.normal(0, 2.5))
                xml.append(f'      <object id="{oid}">\n        '
                           f'<box xc="{cx:.1f}" yc="{cy:.1f}" '
                           f'w="{w:.1f}" h="{h:.1f}"/>\n      </object>')
                oid += 1
                frame_gts.append((1, [cx - w / 2, cy - h / 2, w, h]))
                for _ in range(int(rng.integers(4, 10))):
                    jit = rng.normal(0, 0.1 * w, size=4)
                    bw = max(w + jit[2], 6.0)
                    bh = max(h + jit[3], 12.0)
                    x = cx - w / 2 + jit[0]
                    y = cy - h / 2 + jit[1]
                    pending.append(([x, y, bw, bh],
                                    float(rng.normal(0.55, 0.22))))
            placed += row
        for _ in range(int(rng.integers(5, 20))):   # background FPs
            w = float(rng.uniform(18, 70)); h = float(rng.uniform(30, 130))
            x = float(rng.uniform(0, W - w)); y = float(rng.uniform(0, H - h))
            pending.append(([x, y, w, h], float(rng.normal(0.35, 0.2))))
        qs = (_max_iou_same_cat_many([b for b, _ in pending],
                                     [1] * len(pending), frame_gts)
              if score_corr else np.zeros(len(pending)))
        for (bbox, noise), q in zip(pending, qs):
            s = float(np.clip(score_corr * q + (1.0 - score_corr) * noise,
                              0.01, 0.999))
            csv.append(f"{fr + 1},-1,{bbox[0]:.1f},{bbox[1]:.1f},"
                       f"{bbox[2]:.1f},{bbox[3]:.1f},{s:.3f}")
        xml.append("    </objectlist>\n  </frame>")
    xml.append("</dataset>")
    (data_dir / f"{prefix}pets_gt.xml").write_text("\n".join(xml))
    (data_dir / f"{prefix}pets_dets.csv").write_text("\n".join(csv) + "\n")
    print(f"gen_pets: {n_frames} frames, {len(csv)} det rows -> "
          f"{data_dir}/{prefix}pets_*", flush=True)
    return {"frames": n_frames, "detections": len(csv)}


def pets_yaml(train_steps=3000, lr=1e-3, schedule="cosine", tag="pets",
              mt=False, pre="", data_dir: Path = DATA) -> str:
    """Writes ``cfg_{tag}.yaml`` of the ``pets`` arm: config 2 on the
    ``{pre}pets_*`` files of ``gen_pets`` with their ``val_{pre}`` split
    -> its path."""
    data_dir = Path(data_dir)
    ck = data_dir / f"ck_{tag}"
    thr = MT_THRESHOLDS if mt else "[0.5]"
    return _yaml(data_dir, f"cfg_{tag}.yaml", (
        "model: {num_blocks: 16, feature_dim: 128, reduced_dim: 32, "
        "pairwise_dim: 32, num_classes: 1}\n"
        f"matching: {{thresholds: {thr}}}\n"
        f"data:\n  dataset: pets\n  ann_file: {data_dir / (pre + 'pets_gt.xml')}\n"
        f"  det_file: {data_dir / (pre + 'pets_dets.csv')}\n"
        f"  val_ann_file: {data_dir / ('val_' + pre + 'pets_gt.xml')}\n"
        f"  val_det_file: {data_dir / ('val_' + pre + 'pets_dets.csv')}\n"
        "  max_detections: 1024\n  bucket_sizes: [256, 512, 1024]\n"
        f"train: {{optimizer: adam, learning_rate: {lr}, "
        f"lr_schedule: {schedule}, "
        f"max_steps: {train_steps}, batch_size: 8, grad_clip_norm: 10.0, "
        "snapshot_every: 1000, eval_every: 500, log_every: 100, "
        f"checkpoint_dir: {ck}}}\n"
    ))


def full_pets(train_steps=3000, lr=1e-3, schedule="cosine", tag="pets",
              mt=False, alpha=0.0, device="cuda",
              data_dir: Path = DATA) -> dict:
    """Full-budget PETS-family run through the real-format loaders:
    CVML GT + MOT CSV dets via ``dataset: pets`` in both CLIs, val
    split on held-out frames, best-AP checkpointing, swept-NMS
    baseline — the crowd-benchmark analog of full(). alpha (score_corr)
    prefixes the generated files and suffixes the tag/checkpoint dir
    here, so no caller can train on alpha data while overwriting the
    baseline arm's checkpoints."""
    data_dir = Path(data_dir)
    lab = _alpha_label(alpha)
    pre = f"{lab}_" if lab else ""
    if lab and not tag.endswith(lab):
        tag = f"{tag}_{lab}"
    if not (data_dir / f"{pre}pets_gt.xml").exists():
        gen_pets(prefix=pre, score_corr=alpha, data_dir=data_dir)
    if not (data_dir / f"val_{pre}pets_gt.xml").exists():
        gen_pets(n_frames=200, seed=1, prefix=f"val_{pre}",
                 score_corr=alpha, data_dir=data_dir)
    y = pets_yaml(train_steps, lr, schedule, tag, mt, pre, data_dir)
    _prebuild(device)
    out = {
        f"{tag}_train": _run_phase(
            f"{tag} train ({train_steps} steps, lr={lr}, {schedule})",
            _cli("train", device, "-c", y,
                 "--metrics", str(data_dir / f"m_{tag}.jsonl"))),
        f"{tag}_eval": _run_phase(
            f"{tag} eval (best ckpt, 800 frames, swept-NMS baseline)",
            _cli("evaluate", device, "-c", y, "--best", "--nms-sweep")),
    }
    print(json.dumps(out), flush=True)
    return out


def eval5k(data_dir: Path = DATA) -> dict:
    """The numpy COCOEvaluator over every image of ``gen``'s files (all
    80 classes) -> the printed record; asserts the 60 s target."""
    from gossipnet_tpu_torch import native
    from gossipnet_tpu_torch.data.roidb import build_roidb
    from gossipnet_tpu_torch.eval.cocoeval import COCOEvaluator

    data_dir = Path(data_dir)
    roidb = build_roidb(str(data_dir / "annotations.json"),
                        str(data_dir / "detections.json"),
                        person_only=False, max_dets=1024)
    ev = COCOEvaluator(num_classes=roidb.num_classes, force_numpy=True)
    for rec in roidb:
        ev.add_arrays(rec.image_id, rec.det_boxes, rec.det_scores,
                      rec.det_classes, rec.gt_boxes, rec.gt_classes,
                      rec.gt_crowd)
    t0 = time.monotonic()
    stats = ev.summarize()
    dt = time.monotonic() - t0
    out = {"images": len(roidb), "eval_wall_s": round(dt, 1),
           "numpy_fallback": True, "native_available": native.available(),
           "AP": round(stats["AP"], 4), "AP50": round(stats["AP50"], 4)}
    print(json.dumps(out), flush=True)
    if not dt < 60.0:
        raise AssertionError(
            f"5k numpy-fallback eval took {dt:.1f}s (target <60s)")
    return out


def _parse_arm_args(argv, default_schedule):
    """Parse ``[steps] [lr] [schedule]`` with a literal ``mt`` flag and
    an ``alpha=X`` score-correlation knob accepted at ANY position ->
    (steps, lr, schedule, mt, alpha, extra). Extracting the flags
    before positional binding means `dense 3000 1e-3 mt alpha=0.5`
    works in any order instead of silently binding schedule='mt'.
    ``extra`` is any positionals beyond the first three (the full/full80
    arm reads its tag there)."""
    mt = "mt" in argv
    alpha = 0.0
    a = []
    for x in argv:
        if x == "mt":
            continue
        if x.startswith("alpha="):
            alpha = float(x[6:])
            continue
        a.append(x)
    return (int(a[0]) if a else 3000,
            float(a[1]) if len(a) > 1 else 1e-3,
            a[2] if len(a) > 2 else default_schedule,
            mt, alpha, a[3:])


def _alpha_label(alpha) -> str:
    """Filename/tag-safe label for alpha: '' at 0, 'a80' when the
    2-digit percent form is EXACT, else full precision ('a0p804') —
    two distinct alphas can never share a dataset prefix, tag, or
    checkpoint dir through rounding."""
    if not alpha:
        return ""
    pct = alpha * 100
    if abs(pct - round(pct)) < 1e-9 and 0 < round(pct) < 1000:
        return f"a{int(round(pct)):02d}"
    return "a" + repr(float(alpha)).replace(".", "p").replace("-", "m")


def _with_alpha(density, alpha) -> dict:
    d = dict(density or {})
    if alpha:
        d["score_corr"] = alpha
    return d


def main(argv=None) -> dict:
    """The command line -> the phases' records of the arms it ran (each
    CLI phase's wall time, peak RSS, built libraries, tail and last JSON
    object)."""
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("what", nargs="?", default="all", choices=ARMS)
    p.add_argument("args", nargs="*",
                   help="[steps] [lr] [schedule] [tag] [mt] [alpha=X]")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--data-dir", type=Path, default=DATA)
    args = p.parse_intermixed_args(argv)
    what, rest, data = args.what, args.args, args.data_dir
    if what not in ("gen", "eval5k"):
        from gossipnet_tpu_torch.models.gossipnet import resolve_device

        resolve_device(args.device)     # before any file is generated
    dev = args.device
    out = {}

    if what in ("gen", "all"):
        gen(data_dir=data)
    if what in ("eval5k", "all"):
        eval5k(data)
    if what in ("run", "all"):
        out.update(run(device=dev, data_dir=data))
    if what in ("full", "full80"):
        # full[80] [steps] [lr] [schedule] [tag] [mt] [alpha=X]
        steps, lr, schedule, mt, alpha, extra = _parse_arm_args(
            rest, "constant")
        lab = _alpha_label(alpha)
        tag = ((extra[0] if extra else
                ("full80" if what == "full80" else "full"))
               + ("_mt" if mt else "") + (f"_{lab}" if lab else ""))
        out.update(full(
            train_steps=steps, lr=lr, schedule=schedule, tag=tag,
            multiclass=what == "full80", mt=mt,
            prefix=f"{lab}_" if lab else "",
            density=_with_alpha(None, alpha), device=dev, data_dir=data))
    if what == "pets":
        # pets [steps] [lr] [schedule] [mt] [alpha=X]; full_pets appends
        # the alpha label to the tag itself
        steps, lr, schedule, mt, alpha, _ = _parse_arm_args(rest, "cosine")
        out.update(full_pets(
            train_steps=steps, lr=lr, schedule=schedule,
            tag="pets_mt" if mt else "pets", mt=mt, alpha=alpha,
            device=dev, data_dir=data))
    if what in ("dense", "dense80"):
        # dense[80] [steps] [lr] [schedule] [mt] [alpha=X]: the
        # reference-density arm (300-1024 dets/image, N=1024 bucket
        # dominant); the tag and dataset prefix carry alpha so arms never
        # collide on checkpoint dirs or generated files
        mc = what == "dense80"
        steps, lr, schedule, mt, alpha, _ = _parse_arm_args(rest, "constant")
        lab = _alpha_label(alpha)
        asuf = f"_{lab}" if lab else ""
        tag = ("dense80" if mc else "densep") + (
            "" if schedule == "constant" else f"_{schedule}") + (
            "_mt" if mt else "") + asuf
        out.update(full(
            train_steps=steps, lr=lr, schedule=schedule, tag=tag,
            multiclass=mc, mt=mt,
            prefix=("dense" if mc else "densep") + asuf + "_",
            n_images=2000,
            density=_with_alpha(DENSE if mc else DENSE_P, alpha),
            device=dev, data_dir=data))
    if what == "dense4k":
        # dense4k [steps] [lr] [schedule] [mt] [alpha=X]: config-4
        # training, N=4096-dominant bucketing at batch 2
        steps, lr, schedule, mt, alpha, _ = _parse_arm_args(rest, "cosine")
        lab = _alpha_label(alpha)
        asuf = f"_{lab}" if lab else ""
        tag = "dense4k" + ("" if schedule == "cosine" else f"_{schedule}"
                           ) + ("_mt" if mt else "") + asuf
        out.update(full(
            train_steps=steps, lr=lr, schedule=schedule, tag=tag, mt=mt,
            prefix="dense4k" + asuf + "_", n_images=600,
            density=_with_alpha(DENSE_4K, alpha), **DENSE_4K_ARM,
            device=dev, data_dir=data))
    return out


if __name__ == "__main__":
    main()
