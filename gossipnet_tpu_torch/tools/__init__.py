"""Measuring tools of the port, run as ``python -m gossipnet_tpu_torch.tools.<name>``."""
