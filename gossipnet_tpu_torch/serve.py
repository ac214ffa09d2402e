"""``python -m gossipnet_tpu_torch.serve`` — the serving CLI entry point.

Implementation and docs live in :mod:`gossipnet_tpu_torch.serving`.
"""
from gossipnet_tpu_torch.serving import main

if __name__ == "__main__":
    main()
