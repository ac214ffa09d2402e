"""What the drivers share: the program's config, the device, scratch
space and freeing the program's state before the reference runs."""

from __future__ import annotations

import copy
import gc
import os
import shutil
import tempfile
from contextlib import contextmanager


def program_config(bench, **train_overrides):
    """The configuration file's tree as the program's ``Config``."""
    from gossipnet_tpu_torch.config import load_config

    tree = copy.deepcopy(bench.config["config"])
    tree.setdefault("train", {}).update(train_overrides)
    return load_config(None, overrides=tree)


def model_dict(bench) -> dict:
    return dict(bench.config["config"]["model"])


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@contextmanager
def scratch():
    """A directory of this run under ``TMPDIR``, removed at the end."""
    path = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def memory_peak(device) -> int:
    import torch

    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    """Frees what the program left on the device once its objects are
    dropped, so the reference runs in the memory they held."""
    import torch

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
