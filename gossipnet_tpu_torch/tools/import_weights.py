"""Import a reference (TF-1.x GossipNet) checkpoint: the port's counterpart
of ``scripts/import_weights.py``.

Maps the reference's TF variables onto the parameter tree
(``utils/import_weights.py``) and writes the NPZ that ``Rescorer``,
``evaluate`` and the JAX package read (``utils/export.py``)::

    # inspect what is inside a checkpoint first
    python -m gossipnet_tpu_torch.tools.import_weights --src model.ckpt --list

    # import with the default (guessed) name rules
    python -m gossipnet_tpu_torch.tools.import_weights --src model.ckpt \\
        -c experiments/coco_persons_full.yaml --out imported.npz

    # real checkpoints will likely need a corrected rule map:
    python -m gossipnet_tpu_torch.tools.import_weights --src model.ckpt \\
        -c cfg.yaml --map rules.json --fc1-order ri,rj,g --out imported.npz

``--src`` is an NPZ of variables or a TF checkpoint prefix (reading the
latter needs TensorFlow, imported only then). The importer fails on any
unassigned, doubly assigned or mis-shaped leaf and prints the full source
inventory. It runs on the host alone: no card, no model.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--src", required=True,
                   help=".npz variable dump or TF checkpoint prefix")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--out", default=None, help="output params .npz")
    p.add_argument("--map", dest="rule_map", default=None,
                   help="JSON rule list overriding the default guesses")
    p.add_argument("--fc1-order", default="ri,rj,g",
                   help="reference FC1 input concat order "
                        "(comma list of ri,rj,g)")
    p.add_argument("--list", action="store_true",
                   help="print the source variable inventory and exit")
    args = p.parse_args(argv)

    from gossipnet_tpu_torch.utils import import_weights as iw

    if args.list:
        # shapes only: never materializes a multi-GB checkpoint
        shapes = iw.load_variable_shapes(args.src)
        for name in sorted(shapes):
            print(f"{name}: {shapes[name]}")
        return
    variables = iw.load_variables(args.src)

    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.params import init_params
    from gossipnet_tpu_torch.utils.export import save_params_npz

    cfg = load_config(args.config)
    template = init_params(cfg.model)      # the tree's structure and shapes
    rules = (iw.rules_from_json(args.rule_map) if args.rule_map
             else iw.DEFAULT_RULES)
    params, report = iw.import_params(
        template, variables, rules,
        fc1_order=tuple(args.fc1_order.split(",")))
    print(report.summary())

    out = args.out or "imported_params.npz"
    save_params_npz(out, params)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
