"""Faults planted in the program under a run, to see the check catch
them: a run with one of them switched on (``run.py --fault NAME``, never
passed by the benchmark's own runs) has to come out not correct.

- ``frozen_state``: the optimizer's update does nothing, so every step
  returns its state unchanged (training);
- ``half_batch``: the loss leaves the second half of the batch out and
  takes the mean over the rest (training);
- ``altered_answer``: the first score of every reply is moved by a half,
  where the reply is made (serving).

Each is a context manager that patches one function of the program and
restores it.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def frozen_state():
    from gossipnet_tpu_torch import train

    return _patched(train.OptaxOptimizer, "update",
                    lambda orig: lambda self, apply, hyper: None)


def half_batch():
    from gossipnet_tpu_torch import train

    def make(orig):
        def loss(logits, arrays, cfg, thresholds=None):
            half = logits.shape[0] // 2
            return orig(logits[:half], {k: v[:half] for k, v in
                                        arrays.items()}, cfg, thresholds)
        return loss

    return _patched(train, "matching_loss", make)


def altered_answer():
    from gossipnet_tpu_torch import api

    def make(orig):
        def scatter(host_row, n, keep):
            out = orig(host_row, n, keep).copy()
            if len(out):
                out[0] = (out[0] + 0.5) % 1.0
            return out
        return scatter

    return _patched(api, "_scatter_scores", make)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
