"""Data preparation: COCO ground truth and precomputed detections (the
port's counterpart of ``scripts/prepare_data.py``).

    python -m gossipnet_tpu_torch.tools.prepare_data download
    python -m gossipnet_tpu_torch.tools.prepare_data convert \\
        --dets dets.json --out dets.npz [--person-only]

- ``download``: prints the steps that fetch the COCO annotations and
  where detections come from (any COCO-results JSON of a detector).
- ``convert``: turns COCO-results detections into the compact NPZ that
  ``gossipnet_tpu_torch.data.roidb.load_detections`` reads (xyxy boxes,
  contiguous class labels), which loads ~10x faster than JSON for large
  dumps. Host only, numpy only.
- ``detect`` (running a torchvision detector over an image directory) is
  not part of the port: it needs torchvision and a detector's downloaded
  weights.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

COCO_ANN_URL = "http://images.cocodataset.org/annotations/annotations_trainval2014.zip"


def cmd_download(args):
    print("COCO annotations:")
    print(f"  curl -LO {COCO_ANN_URL} && unzip annotations_trainval2014.zip -d data/")
    print("Detections:")
    print("  - any COCO-results JSON from your detector, then `convert`")


def cmd_convert(args):
    """COCO-results JSON -> NPZ (image_ids, boxes xyxy, scores, classes)."""
    with open(args.dets) as f:
        dets = json.load(f)
    cat_ids = sorted({d["category_id"] for d in dets})
    if args.person_only:
        cat_ids = [1]
    cat_to_label = {c: i for i, c in enumerate(cat_ids)}
    rows = [d for d in dets if d["category_id"] in cat_to_label]
    n = len(rows)
    image_ids = np.zeros(n, np.int64)
    boxes = np.zeros((n, 4), np.float32)
    scores = np.zeros(n, np.float32)
    classes = np.zeros(n, np.int32)
    for i, d in enumerate(rows):
        image_ids[i] = d["image_id"]
        x, y, w, h = d["bbox"]
        boxes[i] = (x, y, x + w, y + h)
        scores[i] = d["score"]
        classes[i] = cat_to_label[d["category_id"]]
    np.savez_compressed(
        args.out, image_ids=image_ids, boxes=boxes, scores=scores,
        classes=classes, cat_ids=np.asarray(cat_ids, np.int64),
    )
    print(f"wrote {args.out}: {n} detections, {len(cat_ids)} classes")


def cmd_detect(args):
    raise SystemExit(
        "prepare_data detect is not ported: it needs torchvision and a "
        "detector's downloaded weights. Give `convert` any COCO-results "
        "JSON of a detector instead.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("download", help="print fetch instructions")

    c = sub.add_parser("convert", help="COCO-results JSON -> NPZ")
    c.add_argument("--dets", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--person-only", action="store_true")

    # the reference's arguments, so that any of its command lines gets the
    # reason instead of a usage error
    d = sub.add_parser("detect", help="not ported (needs torchvision and "
                                      "downloaded detector weights)")
    for flag in ("--images", "--out", "--weights", "--min-score"):
        d.add_argument(flag)

    args = p.parse_args(argv)
    {"download": cmd_download, "convert": cmd_convert,
     "detect": cmd_detect}[args.cmd](args)


if __name__ == "__main__":
    main()
