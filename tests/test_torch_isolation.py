"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points neither hide a missing card nor fall back to the CPU.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gossipnet_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import gossipnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    gossipnet_tpu_torch.__path__, "gossipnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
print(json.dumps({"modules": names, "bad": bad}))
""" % (FORBIDDEN,)


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("ops.cuda.pairwise2", "ops.cuda.pairwise",
                 "ops.cuda.launch", "ops.ranking",
                 "serve", "ops.geometry", "ops.matching",
                 "ops.cuda.matching_scan", "losses", "train",
                 "utils.checkpoint", "utils.metrics", "data.bucketing",
                 "ops.cuda.ablate", "tools.kernel_ablate", "evaluate",
                 "eval.cocoeval", "native", "ops.nms", "data.pets",
                 "data.roidb", "data.synthetic", "serving",
                 "utils.export", "utils.model_artifact",
                 "utils.cuda_graphs", "utils.profiling", "tools.entry",
                 "tools.bench", "tools.bench_suite", "tools.probe",
                 "tools.bench_serving", "tools.tcp_bench_client",
                 "tools.import_weights", "utils.import_weights",
                 "tools.demo_config1", "tools.quality_demo",
                 "tools.calibrate", "tools.scale_drill",
                 "tools.prepare_data", "tools.tile_sweep", "parallel",
                 "parallel.world",
                 "parallel.spmd", "parallel.sharding", "parallel.legs"):
        assert f"gossipnet_tpu_torch.{name}" in result["modules"], name


def test_sources_name_no_jax_module():
    for path in list((ROOT / "gossipnet_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in FORBIDDEN, f"{path}: {line}"


def _cfg():
    from gossipnet_tpu_torch.config import experiment_path, load_config

    return load_config(experiment_path("serving_bucketed"))


def test_rescorer_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.params import init_params

    cfg = _cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Rescorer(cfg, init_params(cfg.model))


def test_serve_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    req = json.dumps({"id": 1, "boxes": [[0, 0, 5, 5]], "scores": [0.5]})
    out = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.serve", "-c",
         str(ROOT / "experiments" / "serving_bucketed.yaml"),
         "--random-init"], input=req + "\n", cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""          # nothing was answered from the CPU


def test_train_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    metrics = tmp_path / "m.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.train", "-c",
         str(ROOT / "experiments" / "coco_persons_full.yaml"),
         "--metrics", str(metrics)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not metrics.exists()          # no step ran on the CPU


def test_serve_cli_without_random_init_names_the_roadmap_item(tmp_path):
    """Serving over a device mesh (roadmap item 14) was refused until it
    was ported (the test keeps its name): with ``parallel.enable: "on"``
    the serve CLI answers on a 1 x 1 mesh, a world of its own process, on
    the CPU when asked; without a card and without ``--device cpu`` it
    still raises before it answers."""
    import yaml

    mesh = tmp_path / "mesh.yaml"
    mesh.write_text(yaml.safe_dump({
        "model": {"num_blocks": 1, "feature_dim": 16, "reduced_dim": 8,
                  "pairwise_dim": 8},
        "data": {"bucket_sizes": [32]}, "parallel": {"enable": "on"}}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    req = json.dumps({"id": 1, "boxes": [[0, 0, 5, 5], [1, 1, 6, 6]],
                      "scores": [0.5, 0.4]})
    cmd = [sys.executable, "-m", "gossipnet_tpu_torch.serve", "-c",
           str(mesh), "--random-init", "--sync"]
    out = subprocess.run(cmd + ["--device", "cpu"], input=req + "\n",
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    reply = json.loads(out.stdout)
    assert reply["id"] == 1 and len(reply["new_scores"]) == 2
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, input=req + "\n", cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert out.stdout == ""


def test_world_ranks_import_no_jax():
    """The spawned ranks of a world start from a fresh interpreter: the
    port's rank programs bring no JAX in, though this process has it."""
    from gossipnet_tpu_torch.parallel import legs
    from gossipnet_tpu_torch.parallel.world import run_world

    out = run_world(legs.run_legs, 2, timeout_s=120, args=(
        [("modules", legs.imported_modules, {"prefixes": FORBIDDEN}),
         ("gather", legs.gather_exact, {"shape": (1, 2)}),
         ("after", legs.imported_modules, {"prefixes": FORBIDDEN})],))
    assert "jax" in sys.modules
    for rank in out:
        assert rank["modules"]["result"] == []
        assert rank["gather"]["result"]
        assert rank["after"]["result"] == []


@pytest.mark.parametrize("tool,argv", [
    ("entry", []), ("bench", []), ("bench", ["--layout", "blob"]),
    ("bench_suite", []), ("probe", ["forward"]), ("probe", ["train"]),
    ("bench_serving", []), ("demo_config1", []),
    ("quality_demo", ["clustered", "--steps", "1"]), ("calibrate", []),
    ("scale_drill", ["run"])])
def test_measuring_tools_default_to_cuda_and_raise_without_a_card(tool,
                                                                  argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    module = importlib.import_module(f"gossipnet_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_tcp_bench_client_imports_neither_torch_nor_the_port(tmp_path):
    client = ROOT / "gossipnet_tpu_torch" / "tools" / "tcp_bench_client.py"
    probe = ("import runpy, sys; runpy.run_path(%r); "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'gossipnet_tpu_torch', 'jax', 'gossipnet_tpu')))"
             % str(client))
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone, without the rest of the repository, it cannot even start
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_kernel_build_paths_stay_in_the_checkout():
    from gossipnet_tpu_torch.ops.cuda import build

    path = build.library_path("pairwise2_fwd")
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libpairwise2_fwd-") and path.suffix == ".so"
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    np.testing.assert_equal(len(path.stem.split("-")[-1]), 16)
    for name in ("pairwise2_bwd", "matching_scan", "pairwise_fwd",
                 "pairwise_bwd", "pair_ablate"):
        assert (build.CSRC / f"{name}.cu").exists()


def test_kernel_library_hash_covers_shared_headers(tmp_path):
    """K1 and K2 share csrc/pairwise2_pair.cuh, K5 and K6
    csrc/pairwise_pair.cuh: an edit to a header must give every kernel
    that includes it a new library path, or a stale build would be
    reused."""
    import shutil

    from gossipnet_tpu_torch.ops.cuda import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {n: build.library_path(n, csrc)
              for n in ("pairwise2_fwd", "pairwise2_bwd", "matching_scan",
                        "pairwise_fwd", "pairwise_bwd", "pair_ablate")}
    assert before["pairwise2_fwd"] == build.library_path("pairwise2_fwd")
    header = csrc / "pairwise2_pair.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, csrc) for n in before}
    assert after["pairwise2_fwd"] != before["pairwise2_fwd"]
    assert after["pairwise2_bwd"] != before["pairwise2_bwd"]
    # K5, K6 and K7 share csrc/pairwise_pair.cuh, which includes K1's header
    assert after["pairwise_fwd"] != before["pairwise_fwd"]
    assert after["pair_ablate"] != before["pair_ablate"]
    header = csrc / "pairwise_pair.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {n: build.library_path(n, csrc) for n in before}
    assert again["pairwise_fwd"] != after["pairwise_fwd"]
    assert again["pairwise_bwd"] != after["pairwise_bwd"]
    assert again["pair_ablate"] != after["pair_ablate"]
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert build.library_path("pairwise2_fwd", csrc) != \
        after["pairwise2_fwd"]
