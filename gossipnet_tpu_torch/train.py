"""Model construction (port of ``gossipnet_tpu/train.py::build_model``).

Only ``build_model`` is ported; the training loop, optimizer and
checkpoints come with the training slice (ROADMAP.md item 9).
"""

from __future__ import annotations

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.models.gossipnet import GossipNet


def build_model(cfg: Config, pool_impl: str = "dense",
                device="cuda") -> GossipNet:
    """An uninitialised GossipNet for ``cfg.model`` on ``device``. The
    forward-only port ignores ``train.remat_blocks``."""
    return GossipNet(cfg.model, pool_impl=pool_impl, device=device)
