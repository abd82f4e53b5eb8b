"""The benchmark's own tests, run from the root of the checkout with
``python -m pytest benchmark/tests``. Tests that need a card carry the
repository's ``cuda`` marker and skip without one; on the chip,
``python -m pytest -m cuda benchmark/tests`` runs them."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs the reference in TF32")
    return torch.device("cuda")
