"""Detection-axis (pair-row) sharded GossipNet forward (port of
``gossipnet_tpu/parallel/spmd.py``).

The O(N^2) pair stage is sharded by rows over the mesh's 'det' axis: each
of the n_det ranks of a data shard pools its NR = N / n_det rows against
all N columns, a rectangular launch of K1 (``pair_kernel: 2``) or K5
(``pair_kernel: 1``), and one gather of the reduced per-detection state
r [B, N, R] per block joins the shards (:class:`~.world.AllGatherRows`).
Every per-detection tensor (c, r, logits) stays row-sharded; the logits
are gathered at the end, so every det rank computes the full loss, and
the gradient closes with a mean over 'det' (``sharding.py``).

The body is the port's ``GossipNet.forward`` itself, given the mesh: one
forward for both paths, so the sharded one cannot drift from the local.
"""

from __future__ import annotations

from torch import Tensor

from gossipnet_tpu_torch.models.gossipnet import GossipNet
from gossipnet_tpu_torch.parallel.world import Mesh


def gossipnet_sharded_forward(model: GossipNet, boxes: Tensor,
                              scores: Tensor, valid: Tensor,
                              classes: Tensor | None = None,
                              mesh: Mesh | None = None) -> Tensor:
    """Row-sharded forward of this rank -> the full logits [B, N], the
    same on every det rank of its data shard.

    boxes [B, N, 4], scores, valid, classes [B, N]: the data shard's
    detections, the same on every det rank; N % n_det == 0. On a mesh
    the pair stage runs the kernel (its plain version on the CPU)
    whatever ``model.pool_impl`` says, and ``model.remat`` recomputes each
    block in the backward, gathering again. With no mesh it is the local
    forward."""
    return model(boxes, scores, valid, classes, mesh=mesh)
