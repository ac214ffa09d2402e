"""gossipnet_tpu_torch — GossipNet learned NMS in PyTorch and CUDA.

A port of ``gossipnet_tpu`` (JAX, TPU) for one NVIDIA H100. It imports
nothing of the JAX package. The serving path is ported (``Rescorer`` in
``api.py``, the JSON-lines server in ``serving.py``, the model in
``models/gossipnet.py``), and so is training (``train.py``, ``losses.py``,
``ops/matching.py``). Their kernels are hand-written CUDA for sm_90a
(``ops/cuda/``): K1 and K2, the pair-pool forward and backward, and K3/K4,
the greedy matching scan. Entry points default to ``device="cuda"`` and
raise when there is no card.
"""

from gossipnet_tpu_torch.config import Config, ModelConfig, load_config

__all__ = ["Config", "ModelConfig", "load_config"]
