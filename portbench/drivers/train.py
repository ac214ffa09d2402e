"""A training cell: ``gossipnet_tpu_torch.train.train`` on a roidb drawn
from the seed, its window ended through ``train(stop=...)``.

Set-up is the process's start, the roidb, the weights and the trainer's
own first steps: at least one pass over the roidb, and until every
(padded N, padded G) shape that the window can reach has been captured
(found by drawing the iterator's batches ahead on the host). The window
opens and closes on a ``torch.cuda.synchronize()``; its rate is the
valid detections of every step dispatched in it over its length.

The check follows the first three steps, which the same ``train`` call
ran through the window's own step and feed: the reference trains its own
copy of the weights on the same three batches, and compared are the
worst step's loss and step 1's (the later steps' losses carry the
trajectories' drift after a greedy-matching label flip between near-tied
detections), the first gradient (from Adam's first moment after step 1)
and the change of the parameters after step 3, each leaf by its norm.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, counts, weights
from portbench.reference import gossipnet as ref_model
from portbench.reference import training as ref_train
from portbench.trace import TRACE_S, Profile
from portbench.traffic import generate

CHECKED_STEPS = 3
STEPS_PER_S = 400      # a bound on the step rate, for the shape horizon


def _roidb(images):
    from gossipnet_tpu_torch.data.roidb import ImageRecord, Roidb

    recs = []
    for i, im in enumerate(images):
        n, g = len(im.scores), len(im.gt_boxes)
        recs.append(ImageRecord(i + 1, im.boxes, im.scores,
                                np.zeros(n, np.int32), im.gt_boxes,
                                np.zeros(g, np.int32), im.gt_crowd))
    return Roidb(recs)


def warm_steps(roidb, cfg, horizon: int) -> int:
    """Steps before the window: one pass over the roidb, and at least up
    to the first batch of every (N, G) shape met in ``horizon`` steps."""
    from gossipnet_tpu_torch.data.bucketing import BatchIterator

    t = cfg.train
    it = BatchIterator(roidb, t.batch_size, cfg.data.bucket_sizes,
                       seed=t.seed, shuffle=cfg.data.shuffle)
    first: dict = {}
    for k in range(horizon):
        b = next(it)
        first.setdefault((b.padded_n, b.padded_g), k)
    one_pass = -(-len(roidb) // t.batch_size)
    return max(one_pass, max(first.values()) + 1)


class Recorder:
    """Sees each step the trainer runs (a ``StepGraphs`` subclass hands
    it the batch and the metrics) and answers the trainer's ``stop``."""

    def __init__(self, bench, device, warm: int, profile: Profile):
        self.bench, self.device, self.warm = bench, device, warm
        self.profile = profile
        self.state = None
        self.calls = 0
        self.first = []          # (arrays, loss tensor) of steps 1..3
        self.mu1 = None          # Adam's first moment after step 1
        self.theta3 = None       # the parameters after step 3
        self.valid = []          # valid detections of every step
        self.rows = []           # (boxes, valid) of the window's steps
        self.phase = "warm"
        self.n_open = self.n_close = 0
        self.n_trace = None      # steps dispatched when the trace closed
        self.captures_open = 0

    def graphs_class(self, base):
        rec = self

        class Recorded(base):
            def __init__(self, state, cfg, body):
                super().__init__(state, cfg, body)
                rec.state = state
                rec.graphs = self

            def __call__(self, arrays):
                metrics = super().__call__(arrays)
                rec.after_step(arrays, metrics)
                return metrics

        return Recorded

    def after_step(self, arrays, metrics) -> None:
        self.calls += 1
        self.valid.append(int(np.count_nonzero(arrays["valid"])))
        if self.calls <= CHECKED_STEPS:
            self.first.append(({k: np.array(v) for k, v in arrays.items()},
                               metrics["loss"]))
            opt = self.state.optimizer
            params = opt.param_groups[0]["params"]
            if self.calls == 1:
                # a slot the update never made reads as its zeros
                self.mu1 = [opt.state[p]["mu"].detach().clone()
                            if "mu" in opt.state[p] else p.new_zeros(p.shape)
                            for p in params]
            if self.calls == CHECKED_STEPS:
                self.theta3 = [p.detach().clone() for p in params]
        if (self.phase == "window" and self.bench.trace
                and self.n_trace is None):
            self.rows.append((arrays["boxes"], arrays["valid"]))

    def stop(self) -> bool:
        if self.phase == "warm":
            if self.calls >= self.warm:
                common.sync(self.device)
                self.t_open = time.monotonic()
                self.bench.ready()
                self.n_open = self.calls
                self.captures_open = self.graphs.captures
                self.phase = "window"
                self.profile.open()
            elif self.calls == self.warm - 1:
                self.profile.start()
            return False
        if self.phase == "window":
            now = time.monotonic()
            if (self.bench.trace and self.n_trace is None
                    and now - self.t_open >= min(TRACE_S, self.bench.seconds)):
                common.sync(self.device)
                self.profile.close()
                self.profile.stop()
                self.n_trace = self.calls
            if now - self.t_open < self.bench.seconds:
                return False
            common.sync(self.device)
            self.t_close = time.monotonic()
            self.n_close = self.calls
            self.phase = "done"
        return True


def run(bench) -> None:
    import torch

    from gossipnet_tpu_torch import train as program

    device = torch.device(bench.device)
    model = common.model_dict(bench)
    with common.scratch() as tmp:
        cfg = common.program_config(bench, checkpoint_dir=f"{tmp}/ckpt")
        images = generate.roidb_images(bench.seed, bench.traffic,
                                       cfg.data.max_detections)
        roidb = _roidb(images)
        horizon = int(bench.seconds * STEPS_PER_S) + 1
        warm = warm_steps(roidb, cfg, horizon + len(roidb))
        params = weights.make(model, bench.seed, device)
        profile = Profile(bench.trace)
        rec = Recorder(bench, device, warm, profile)
        base = program.StepGraphs
        program.StepGraphs = rec.graphs_class(base)
        try:
            state = program.train(cfg, roidb, pool_impl="kernel",
                                  stop=rec.stop, device=device,
                                  params=params, max_steps=10 ** 9)
        finally:
            program.StepGraphs = base
        bench.memory_peak_bytes = common.memory_peak(device)
        window = rec.t_close - rec.t_open
        steps = rec.n_close - rec.n_open
        dets = sum(rec.valid[rec.n_open:rec.n_close])
        bench.window_s = window
        metric = bench.workload.get("rate_metric", "train_dets_per_s")
        bench.end_to_end[metric] = dets / window
        bench.attempted = steps
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
            bench.layer.update(_work(images, rec, model, cfg,
                                     rec.n_trace - rec.n_open))
        rec.state = rec.graphs = state = None
        common.release(device)

    _check(bench, params, batches, losses, mu1, theta3, b1, cfg, model)


def _work(images, rec, model: dict, cfg, steps: int) -> dict:
    """Neighbour pairs and detections of the traced steps."""
    pairs_of = {}
    for im in images:
        key = (len(im.scores), im.boxes[:1].tobytes())
        pairs_of[key] = counts.neighbour_pairs(im.boxes,
                                               cfg.model.neighbor_iou)
    pairs = dets = 0
    for boxes, valid in rec.rows:
        for r in range(len(boxes)):
            n = int(np.count_nonzero(valid[r]))
            dets += n
            pairs += pairs_of[(n, boxes[r, :1].tobytes())]
    return {"model": model, "pairs": pairs, "dets": dets,
            "launches": steps * model["num_blocks"], "steps": steps,
            "params": weights.parameter_count(model)}


def _images(arrays) -> list:
    out = []
    for r in range(arrays["boxes"].shape[0]):
        v, gv = arrays["valid"][r], arrays["gt_valid"][r]
        out.append((arrays["boxes"][r][v], arrays["scores"][r][v],
                    arrays["gt_boxes"][r][gv], arrays["gt_crowd"][r][gv]))
    return out


def leaf_gaps(program: dict, reference: dict, names) -> dict:
    """Each leaf's gap between the two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    ref = {k: float(reference[k].norm()) for k in names}
    med = float(np.median(list(ref.values())))
    return {k: abs(float(program[k].norm()) - ref[k]) / max(ref[k], med)
            for k in names}


def _check(bench, params, batches, losses, mu1, theta3, b1, cfg,
           model) -> None:
    ref_model.no_tf32()
    t = cfg.train
    thresholds = list(cfg.matching.thresholds)
    adam = ref_train.Adam(params, t.learning_rate, t.grad_clip_norm)
    theta = {k: v.detach().clone() for k, v in params.items()}
    ref_losses, g1 = [], None
    for arrays in batches:
        loss, grads = ref_train.loss_and_grads(
            theta, _images(arrays), model["num_blocks"], thresholds)
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
    grad = leaf_gaps(g_prog, g1, names)
    upd = leaf_gaps(d_prog, d_ref, moving)
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
