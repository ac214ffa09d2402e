"""Nothing a run loads imports JAX, its libraries or the JAX package, and
the reference loads nothing of the port. Each check imports in a fresh
interpreter and reads its ``sys.modules`` by whole top-level names
(``gossipnet_tpu_torch`` is not ``gossipnet_tpu``)."""

import json
import subprocess
import sys

from portbench.bench import HERE, ROOT
from portbench.run import FORBIDDEN, forbidden_modules

TOP_NAMES = ("print(json.dumps(sorted({m.split('.')[0]"
             " for m in sys.modules})))")
RUN_MODULES = [
    "portbench.run", "portbench.drivers.train", "portbench.drivers.serve",
    "portbench.drivers.serve_open", "portbench.drivers.serve_closed",
    "portbench.tools.knee", "portbench.faults", "portbench.trace",
    "gossipnet_tpu_torch.train", "gossipnet_tpu_torch.serving",
    "gossipnet_tpu_torch.api", "gossipnet_tpu_torch.utils.cuda_graphs",
]
REFERENCE_MODULES = ["portbench.reference.gossipnet",
                     "portbench.reference.training", "portbench.weights",
                     "portbench.counts", "portbench.traffic.generate"]


def loaded_after(modules: list[str]) -> set[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            + TOP_NAMES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_the_check_compares_whole_names():
    assert forbidden_modules(["gossipnet_tpu_torch.train", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["gossipnet_tpu.train"]) == ["gossipnet_tpu"]
    assert forbidden_modules(["jax._src", "flax"]) == ["flax", "jax"]


def test_run_modules_load_no_jax():
    top = loaded_after(RUN_MODULES)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "gossipnet_tpu_torch" in top


def test_metric_readers_load_no_jax():
    code = ("import json, sys\nfrom portbench import run\n"
            f"for p in sorted(__import__('pathlib').Path({str(HERE)!r})"
            ".joinpath('metrics').glob('*.*.py')): run.reader(p.stem)\n"
            + TOP_NAMES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert not set(json.loads(out.splitlines()[-1])) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    top = loaded_after(REFERENCE_MODULES)
    assert "gossipnet_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
