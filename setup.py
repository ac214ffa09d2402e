"""Build hooks that make the package survive `pip install` (VERDICT r4 #5).

Two things do not live under ``gossipnet_tpu/`` in the repo layout and
would otherwise silently vanish from a wheel:

* ``native/gossip_native.cc`` — the host-side C++ fast paths (COCO eval
  matching, NMS sweep oracle). Built here as a setuptools Extension named
  ``gossipnet_tpu._gossip_native`` so the compiled .so lands INSIDE the
  installed package; gossipnet_tpu/native.py loads it via ctypes (the
  PyInit symbol an Extension would need for `import` is irrelevant —
  ctypes dlopens the file directly). Without it, installed consumers
  dropped to the numpy fallbacks with no signal (a ~6.5x slower eval
  sweep, BENCHMARKS.md).
* ``experiments/*.yaml`` — the shipped experiment recipes, copied into
  ``gossipnet_tpu/experiments/`` at build time and resolvable via
  :func:`gossipnet_tpu.config.experiment_path` in both layouts.

pybind11 is deliberately not used (not in the environment); the ABI is
plain C with a version handshake (native.py).

The PyTorch port ``gossipnet_tpu_torch`` ships the same things beside it:
its own ``gossipnet_tpu_torch._gossip_native`` extension from the same
source, the same YAMLs in ``gossipnet_tpu_torch/experiments/``, and its
CUDA sources (``ops/cuda/csrc/*.cu``, ``*.cuh``; MANIFEST.in carries them
into an sdist), which it compiles with ``nvcc`` at first use.
"""

import shutil
from pathlib import Path

from setuptools import Extension, setup
from setuptools.command.build_py import build_py as _build_py

ROOT = Path(__file__).resolve().parent
# The port's data files: (directory under ROOT, directory under
# gossipnet_tpu_torch/ in the build, pattern).
PORT_DATA = (
    ("gossipnet_tpu_torch/ops/cuda/csrc", "ops/cuda/csrc", "*.cu"),
    ("gossipnet_tpu_torch/ops/cuda/csrc", "ops/cuda/csrc", "*.cuh"),
    ("experiments", "experiments", "*.yaml"),
)


class build_py(_build_py):
    """Copy repo-root experiments/*.yaml into the package being built."""

    def run(self):
        super().run()
        src = ROOT / "experiments"
        dst = Path(self.build_lib) / "gossipnet_tpu" / "experiments"
        if src.is_dir():
            dst.mkdir(parents=True, exist_ok=True)
            for y in sorted(src.glob("*.yaml")):
                shutil.copy2(y, dst / y.name)
        # and the port's CUDA sources and YAMLs into gossipnet_tpu_torch/
        port = Path(self.build_lib) / "gossipnet_tpu_torch"
        for src_dir, dst_dir, pattern in PORT_DATA:
            for f in sorted((ROOT / src_dir).glob(pattern)):
                (port / dst_dir).mkdir(parents=True, exist_ok=True)
                shutil.copy2(f, port / dst_dir / f.name)


setup(
    cmdclass={"build_py": build_py},
    package_data={"gossipnet_tpu": ["experiments/*.yaml"]},
    ext_modules=[
        Extension(
            "gossipnet_tpu_torch._gossip_native",
            sources=["native/gossip_native.cc"],
            language="c++",
            extra_compile_args=["-O3", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        ),
        Extension(
            "gossipnet_tpu._gossip_native",
            sources=["native/gossip_native.cc"],
            language="c++",
            extra_compile_args=["-O3", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        )
    ],
)
