"""A training cell of the multi-class model (config 3):
``gossipnet_tpu_torch.train.train`` on a roidb of all 80 classes drawn
from the seed (``traffic/drill80.py``), with the window, the warm-up and
the rate of ``drivers/train.py``, so that ``train_dets_per_s`` means the
same thing.

The check compares the same four numbers as ``drivers/train.py``'s on the
first three steps, against ``reference/multiclass.py``: the class-aware
forward, matching within classes at the configuration's thresholds,
Adam with clipping. The reference's first step matches in the order of
the program's own first logits (``first_logits``), so that the first
gradients are compared on the same targets: the two forwards differ in
the last bits, and near-tied detections of one ground truth would
otherwise take it in either order, at a few seeds in the gradient of a
whole block.

Traced, the run also reads K3's rows launched
(``greedy_scan_batched.rows_launched``, a host count that a graph replay
re-adds) where the trace opens and where it closes; a program without
that counter leaves ``match_rows`` out.
"""

from __future__ import annotations

import numpy as np

from portbench import common, weights_multiclass
from portbench.drivers import train as base
from portbench.reference import multiclass as ref_mc
from portbench.reference import training as ref_train
from portbench.trace import Profile
from portbench.traffic import drill80


def _roidb(images):
    from gossipnet_tpu_torch.data.roidb import ImageRecord, Roidb

    recs = [ImageRecord(i + 1, im.boxes, im.scores, im.classes,
                        im.gt_boxes, im.gt_classes, im.gt_crowd)
            for i, im in enumerate(images)]
    cat_ids = sorted(drill80.LABEL)
    return Roidb(recs, [f"cat_{c}" for c in cat_ids], cat_ids)


def rows_launched():
    """K3's rows launched so far, or None in a program without the
    counter."""
    from gossipnet_tpu_torch.ops.cuda import matching_scan

    return getattr(matching_scan.greedy_scan_batched, "rows_launched", None)


class RowsProfile(Profile):
    """The window's profile, reading K3's rows launched where the trace
    opens and where it closes."""

    rows_open = rows_close = None

    def open(self) -> None:
        self.rows_open = rows_launched()
        super().open()

    def close(self) -> None:
        super().close()
        self.rows_close = rows_launched()


def run(bench) -> None:
    import torch

    from gossipnet_tpu_torch import train as program

    device = torch.device(bench.device)
    model = common.model_dict(bench)
    with common.scratch() as tmp:
        cfg = common.program_config(bench, checkpoint_dir=f"{tmp}/ckpt")
        images = drill80.roidb_images(bench.seed, bench.traffic,
                                      cfg.data.max_detections)
        roidb = _roidb(images)
        horizon = int(bench.seconds * base.STEPS_PER_S) + 1
        warm = base.warm_steps(roidb, cfg, horizon + len(roidb))
        params = weights_multiclass.make(model, bench.seed, device)
        profile = RowsProfile(bench.trace)
        rec = base.Recorder(bench, device, warm, profile)
        graphs = program.StepGraphs
        program.StepGraphs = rec.graphs_class(graphs)
        try:
            state = program.train(cfg, roidb, pool_impl="kernel",
                                  stop=rec.stop, device=device,
                                  params=params, max_steps=10 ** 9)
        finally:
            program.StepGraphs = graphs
        bench.memory_peak_bytes = common.memory_peak(device)
        window = rec.t_close - rec.t_open
        dets = sum(rec.valid[rec.n_open:rec.n_close])
        bench.window_s = window
        bench.end_to_end["train_dets_per_s"] = dets / window
        bench.attempted = rec.n_close - rec.n_open
        if rec.graphs.captures != rec.captures_open:
            bench.notes.append(f"{rec.graphs.captures - rec.captures_open} "
                               "shapes captured inside the window")
        losses = [float(loss) for _, loss in rec.first]
        names = [n for n, _ in state.model.named_parameters()]
        mu1 = {n: t.float() for n, t in zip(names, rec.mu1)}
        theta3 = {n: t.float() for n, t in zip(names, rec.theta3)}
        batches = [arrays for arrays, _ in rec.first]
        b1 = state.optimizer.param_groups[0]["b1"]
        if bench.trace:
            bench.profile = profile
            work = base._work(images, rec, model, cfg,
                              rec.n_trace - rec.n_open)
            work["params"] = weights_multiclass.parameter_count(model)
            if profile.rows_open is not None:
                work["match_rows"] = profile.rows_close - profile.rows_open
            bench.layer.update(work)
        rec.state = rec.graphs = state = None
        common.release(device)
        order = first_logits(cfg, params, batches[0], device)

    _check(bench, params, batches, losses, mu1, theta3, b1, cfg, model,
           order)


def first_logits(cfg, params, arrays, device) -> list:
    """The program's logits of its first step, per image over its valid
    rows: the model of ``cfg`` at the initial ``params``, run eagerly on
    the first batch (the captured step is bit-equal to the eager one)."""
    import torch

    from gossipnet_tpu_torch.train import build_model

    net = build_model(cfg, "kernel", device)
    net.load_state_dict(params)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in arrays.items()}
    with torch.no_grad():
        logits = net(t["boxes"], t["scores"], t["valid"], t["classes"])
    logits = logits.float().cpu().numpy()
    return [logits[r][v] for r, v in enumerate(arrays["valid"])]


def _images(arrays) -> list:
    out = []
    for r in range(arrays["boxes"].shape[0]):
        v, gv = arrays["valid"][r], arrays["gt_valid"][r]
        out.append((arrays["boxes"][r][v], arrays["scores"][r][v],
                    arrays["classes"][r][v], arrays["gt_boxes"][r][gv],
                    arrays["gt_classes"][r][gv], arrays["gt_crowd"][r][gv]))
    return out


def _check(bench, params, batches, losses, mu1, theta3, b1, cfg,
           model, order) -> None:
    """``drivers/train.py``'s four numbers, against the class-aware
    reference, whose first step matches in ``order``."""
    t = cfg.train
    thresholds = list(cfg.matching.thresholds)
    adam = ref_train.Adam(params, t.learning_rate, t.grad_clip_norm)
    theta = {k: v.detach().clone() for k, v in params.items()}
    ref_losses, g1 = [], None
    for step, arrays in enumerate(batches):
        loss, grads = ref_mc.loss_and_grads(
            theta, _images(arrays), model["num_blocks"], thresholds,
            order=order if step == 0 else None)
        if g1 is None:
            raw = float(np.sqrt(sum(float(g.norm()) ** 2
                                    for g in grads.values())))
        theta, clipped = adam.step(theta, grads)
        ref_losses.append(loss)
        g1 = clipped if g1 is None else g1
    names = list(params)
    g_prog = {k: mu1[k] / (1 - b1) for k in names}
    gnorm = {k: float(g1[k].norm()) for k in names}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k in names if gnorm[k] >= 1e-3 * med]
    d_prog = {k: theta3[k] - params[k] for k in names}
    d_ref = {k: theta[k] - params[k] for k in names}
    step_gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref_losses)]
    grad = base.leaf_gaps(g_prog, g1, names)
    upd = base.leaf_gaps(d_prog, d_ref, moving)
    worst_g, worst_u = max(grad, key=grad.get), max(upd, key=upd.get)
    numbers = {
        "loss_gap": max(step_gaps),
        "loss_gap_step1": step_gaps[0],
        "grad_gap": grad[worst_g],
        "update_gap": upd[worst_u],
    }
    bench.notes.append(
        f"losses {losses!r} reference {ref_losses!r}; first gradient's "
        f"norm {raw!r} (clipped at {t.grad_clip_norm}); worst leaves: "
        f"gradient {worst_g}, change {worst_u}; "
        f"{len(names) - len(moving)} leaves left out of the change")
    for name, value in numbers.items():
        bench.check(name, value, bench.workload["limits"][name])
    bench.failed = 0 if bench.correct else 1
