"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that run cells on the card and skip without one.

    python -m pytest portbench/tests            # here, on the CPU
    python -m pytest -m cuda portbench/tests    # on a machine with a card
"""

import pytest


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
