"""The one generator of every traffic mix: it reads a mix's data file
(``traffic/mixes/<name>.json``) and the run's seed, and returns the images
and, for served traffic, the arrivals.

Keys of a mix file:

- ``kind``: ``roidb`` (a training set cycled by the trainer), ``open``
  (arrivals on a schedule, whatever the replies do) or ``closed`` (each
  client sends its next request when its last reply is in);
- ``pool``: images drawn per drill preset (``drill.PRESETS``), e.g.
  ``{"dense_p": 256}``, from ``pool_seed``; a ``roidb`` is the pools
  joined;
- ``mix``: the share of requests of each preset (``open``, ``closed``);
- ``rate_per_s`` and ``connections`` (``open``, Poisson arrivals);
  ``clients`` (``closed``);
- ``sample``: how many answered requests the check compares;
- ``warm_s``: seconds of the same traffic before the window (set-up: the
  server's windows and buffers settle; not measured).
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import drill


def stream_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  *(ord(c) for c in stream)])


def pools(seed: int, mix: dict, max_dets: int) -> dict[str, list]:
    """preset -> its images, each pool from its own stream of the mix's
    fixed ``pool_seed``: every run's requests come from the same images,
    so a seed changes the order of the work and not its size. (``seed``
    draws the pools instead where the mix gives no ``pool_seed``.)"""
    base = int(mix.get("pool_seed", seed))
    return {preset: drill.draw(base, f"pool.{preset}", preset, int(count),
                               max_dets)
            for preset, count in sorted(mix["pool"].items())}


def roidb_images(seed: int, mix: dict, max_dets: int) -> list:
    """A training set: every pool's images, in an order drawn from the
    seed (the trainer's iterator then batches them in that order's
    shuffle)."""
    ims = [im for _, ims in sorted(pools(seed, mix, max_dets).items())
           for im in ims]
    order = stream_rng(seed, "roidb").permutation(len(ims))
    return [ims[i] for i in order]


def requests(seed: int, mix: dict, count: int, stream: str) -> list:
    """``count`` picks (preset, index into its pool), the preset drawn by
    the mix's shares and the image uniformly within its pool."""
    rng = stream_rng(seed, stream)
    names = sorted(mix["mix"])
    p = np.asarray([mix["mix"][k] for k in names], np.float64)
    kinds = rng.choice(len(names), size=count, p=p / p.sum())
    sizes = {k: int(mix["pool"][k]) for k in names}
    return [(names[k], int(rng.integers(sizes[names[k]]))) for k in kinds]


def poisson_arrivals(seed: int, mix: dict, seconds: float,
                     stream: str = "arrivals") -> np.ndarray:
    """Due times (seconds from the start) of a Poisson process at
    ``rate_per_s`` over ``seconds``."""
    rng = stream_rng(seed, stream)
    rate = float(mix["rate_per_s"])
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 1.5) + 64)
    due = np.cumsum(gaps)
    while due[-1] < seconds:   # a long tail of gaps, vanishingly rare
        due = np.concatenate([due, due[-1] + np.cumsum(
            rng.exponential(1.0 / rate, size=len(due)))])
    return due[due < seconds]
