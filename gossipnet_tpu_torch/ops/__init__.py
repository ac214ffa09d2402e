"""Detection ops of the PyTorch port: box geometry, pair features, score
rank, Morton order, greedy matching, and the kernels (``ops/cuda``)."""
