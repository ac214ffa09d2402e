"""The plain reference: GossipNet's forward, the training loss and Adam in
plain PyTorch and numpy, float32 with TF32 off. It imports nothing of the
port and takes nothing the port has made: it reads the weights and inputs
the benchmark made, and the port's outputs only to judge them."""
