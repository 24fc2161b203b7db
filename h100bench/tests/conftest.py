"""The benchmark's tests: ``python -m pytest h100bench/tests`` from the
root of a checkout.  Tests marked ``gpu`` run on the card and skip here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
