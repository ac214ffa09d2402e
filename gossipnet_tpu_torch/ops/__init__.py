"""Detection ops of the PyTorch port: pair features, score rank, Morton
order and the pair-pool kernel (``ops/cuda``)."""
