"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root. They run on the CPU at cut sizes through the
kernels' plain versions; tests marked ``gpu`` need a card and skip
without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _work_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from mosaicbench.kinds import sortie
    monkeypatch.setattr(sortie, "TERRAIN_CACHE", str(tmp_path / "terrain"))
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
