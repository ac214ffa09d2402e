"""Checkpoint/resume on ``torch.save`` (port of
``gossipnet_tpu/utils/checkpoint.py``, which uses orbax).

A checkpoint holds the FULL resumable state — model and optimizer
``state_dict``, the learning-rate schedule, the step, the generator state
(``TrainState.state_dict`` in ``train.py``) — and a host sidecar JSON with
the data iterator's position, so a restart replays the exact training
stream. Periodic checkpoints keep the newest ``max_to_keep``; a 'best'
checkpoint with ``best.json`` is kept beside them.

Layout under ``directory``: ``steps/<step>.pt``, ``host_<step>.json``,
``best/state.pt``, ``best.json``. Files are written to a temporary name and
renamed, so a crash never leaves a half-written checkpoint as the newest.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch


def _atomic_save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Periodic + best checkpoints of an object with ``state_dict()`` /
    ``load_state_dict()``, with host-side sidecar JSON."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.steps_dir = self.directory / "steps"
        self.steps_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_metric = self._load_sidecar("best.json").get("metric", -1.0)

    # --- sidecar helpers ---
    def _load_sidecar(self, name: str) -> dict:
        p = self.directory / name
        return json.loads(p.read_text()) if p.exists() else {}

    def _write_sidecar(self, name: str, data: dict) -> None:
        (self.directory / name).write_text(json.dumps(data))

    # --- periodic ---
    def all_steps(self) -> list[int]:
        steps = []
        for p in self.steps_dir.glob("*.pt"):
            try:
                steps.append(int(p.stem))
            except ValueError:
                continue
        return sorted(steps)

    def save(self, step: int, state: Any,
             host_state: dict | None = None) -> None:
        if host_state is not None:
            self._write_sidecar(f"host_{step}.json", host_state)
        _atomic_save(state.state_dict(), self.steps_dir / f"{step}.pt")
        kept = self.all_steps()[-self.max_to_keep:] if self.max_to_keep \
            else self.all_steps()
        for s in self.all_steps():
            if s not in kept:
                (self.steps_dir / f"{s}.pt").unlink(missing_ok=True)
        # prune host sidecars alongside the retained steps
        for p in self.directory.glob("host_*.json"):
            try:
                s = int(p.stem.split("_")[1])
            except ValueError:
                continue
            if s not in kept:
                p.unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: Any, step: int | None = None):
        """Loads checkpoint ``step`` (default: the newest) into ``state``
        in place -> (state, host_state dict)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state.load_state_dict(torch.load(self.steps_dir / f"{step}.pt",
                                         map_location="cpu",
                                         weights_only=False))
        return state, self._load_sidecar(f"host_{step}.json")

    # --- best ---
    def maybe_save_best(self, metric: float, state: Any) -> bool:
        if metric <= self._best_metric:
            return False
        self._best_metric = metric
        best_dir = self.directory / "best"
        best_dir.mkdir(exist_ok=True)
        _atomic_save(state.state_dict(), best_dir / "state.pt")
        self._write_sidecar("best.json", {"metric": metric})
        return True
