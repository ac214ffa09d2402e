"""gossipnet_tpu_torch — GossipNet learned NMS in PyTorch and CUDA.

A port of ``gossipnet_tpu`` (JAX, TPU) for one NVIDIA H100. It imports
nothing of the JAX package. The serving path is ported (``Rescorer`` in
``api.py``, the JSON-lines, TCP and file-mode servers in ``serving.py``,
serving artifacts in ``utils/model_artifact.py``, the model in
``models/gossipnet.py``), and so are training (``train.py``,
``losses.py``, ``ops/matching.py``) and evaluation (``evaluate.py``).
Their kernels are hand-written CUDA for sm_90a (``ops/cuda/``): K1/K2 and
K5/K6, the pair-pool forwards and backwards, K3/K4, the greedy matching
scan, and K7, the ablation probe. Entry points default to
``device="cuda"`` and raise when there is no card.
"""

from gossipnet_tpu_torch.config import Config, ModelConfig, load_config

__all__ = ["Config", "ModelConfig", "load_config"]
