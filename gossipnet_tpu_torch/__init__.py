"""gossipnet_tpu_torch — GossipNet learned NMS in PyTorch and CUDA.

A port of ``gossipnet_tpu`` (JAX, TPU) for one NVIDIA H100. It imports
nothing of the JAX package. The serving path is ported: ``Rescorer``
(``api.py``), the JSON-lines server (``serving.py``), the model
(``models/gossipnet.py``) and its pair-pool kernel K1, hand-written CUDA
for sm_90a (``ops/cuda/``). Entry points default to ``device="cuda"`` and
raise when there is no card.
"""

from gossipnet_tpu_torch.config import Config, ModelConfig, load_config

__all__ = ["Config", "ModelConfig", "load_config"]
