"""GossipNet model (PyTorch)."""
