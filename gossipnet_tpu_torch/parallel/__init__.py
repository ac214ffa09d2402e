"""Device-mesh execution over ``torch.distributed`` (port of
``gossipnet_tpu/parallel/``): ``world.py`` (the process world, the mesh,
the row gather), ``spmd.py`` (the det-row-sharded forward),
``sharding.py`` (the mesh from the config, sharded inference, gradients
and train step)."""

from gossipnet_tpu_torch.parallel.sharding import (  # noqa: F401
    DATA_AXIS,
    DET_AXIS,
    make_mesh,
    make_sharded_inference,
    make_sharded_train_step,
)
from gossipnet_tpu_torch.parallel.spmd import (  # noqa: F401
    gossipnet_sharded_forward,
)
