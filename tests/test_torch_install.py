"""The port from an installed wheel (the port's twin of
``tests/test_package_install.py``), and where its kernels are built.

A wheel installs ``gossipnet_tpu_torch`` with its shipped experiment YAMLs,
its CUDA sources (``ops/cuda/csrc/*.cu``, ``*.cuh``: the kernels are
compiled from them at first use) and its own ``_gossip_native`` extension
(the C++ COCO matching and NMS sweep). From the install, with a neutral
working directory so that the checkout cannot shadow it, the port must
resolve its configs, find its sources and native library, build its
kernels in a user cache directory (not in site-packages) and import no
JAX. The wheel test builds offline (``--no-build-isolation --no-deps``)
and is marked ``slow``, as the reference's is.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import os
import pathlib
import subprocess
import sys

import pytest

from gossipnet_tpu_torch.ops.cuda import build

ROOT = pathlib.Path(__file__).resolve().parents[1]

SMOKE = r"""
import json, os, sys
site = os.environ["GNET_SITE"]
import gossipnet_tpu_torch
assert gossipnet_tpu_torch.__file__.startswith(site), gossipnet_tpu_torch.__file__
from gossipnet_tpu_torch import native
assert native.available(), "native library missing in the installed layout"
assert str(native._find_lib()).startswith(site), native._find_lib()
from gossipnet_tpu_torch.config import experiment_path, load_config
cfg = load_config(experiment_path("coco_persons_best"))
assert cfg.model.num_blocks == 16
from gossipnet_tpu_torch.ops.cuda import build
assert str(build.CSRC).startswith(site), build.CSRC
names = sorted(p.name for p in build.CSRC.iterdir())
assert not str(build.BUILD_DIR).startswith(site), build.BUILD_DIR
assert str(build.BUILD_DIR).startswith(os.environ["XDG_CACHE_HOME"])
from gossipnet_tpu_torch.api import Rescorer  # noqa: F401
from gossipnet_tpu_torch.tools import bench, probe  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "orbax", "gossipnet_tpu"))
print(json.dumps({"csrc": names, "bad": bad}))
"""


@pytest.mark.slow
def test_wheel_installs_the_port_with_sources_configs_and_native(tmp_path):
    wheel_dir = tmp_path / "wheels"
    site = tmp_path / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(ROOT), "--no-deps",
         "--no-build-isolation", "-w", str(wheel_dir)],
        check=True, capture_output=True, text=True)
    wheels = list(wheel_dir.glob("gossipnet_tpu-*.whl"))
    assert len(wheels) == 1, wheels
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--target", str(site), str(wheels[0])],
        check=True, capture_output=True, text=True)
    assert list(site.glob("gossipnet_tpu_torch/_gossip_native*.so"))
    assert (site / "gossipnet_tpu_torch/experiments/coco_persons_best.yaml"
            ).exists()

    env = dict(os.environ, PYTHONPATH=str(site), GNET_SITE=str(site),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    env.pop("GOSSIP_NATIVE_LIB", None)
    out = subprocess.run(
        [sys.executable, "-c", SMOKE], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    import json

    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    shipped = sorted(p.name for p in build.CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh"))
    assert result["csrc"] == shipped

    out = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.tools.bench", "--help"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "usage" in out.stdout.lower()


def test_build_dir_in_a_checkout_is_the_checkout_build_directory():
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    pkg = ROOT / "gossipnet_tpu_torch"
    assert build.default_build_dir(pkg, {}) == ROOT / "build" / \
        "torch_kernels"


def test_build_dir_outside_a_checkout_is_the_user_cache(tmp_path):
    pkg = tmp_path / "site-packages" / "gossipnet_tpu_torch"
    pkg.mkdir(parents=True)
    cache = tmp_path / "xdg"
    got = build.default_build_dir(pkg, {"XDG_CACHE_HOME": str(cache)})
    assert got == cache / "gossipnet_tpu_torch" / "torch_kernels"
    home = build.default_build_dir(pkg, {})
    assert home == pathlib.Path.home() / ".cache" / "gossipnet_tpu_torch" \
        / "torch_kernels"
    assert tmp_path / "site-packages" not in got.parents
    assert tmp_path / "site-packages" not in home.parents
