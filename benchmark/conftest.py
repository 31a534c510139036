"""pytest settings of the benchmark's own tests (benchmark/test_*.py).

`chip` marks a test that needs the card; it skips, with its reason, where
torch sees no CUDA device. Run them on the card with
`python3 -m pytest benchmark -m chip`.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
