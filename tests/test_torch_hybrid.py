"""Port vs reference: the hybrid family (zamba2-1.2b, reduced to 5 layers:
2 super-layers of 2 Mamba blocks and the shared attention block, and a
tail of 1).

The cases are ``tests/lm_family_cases.py``'s (see there what each holds);
this file gives them the architecture.
"""
import pytest
import torch

from lm_family_cases import *  # noqa: F401,F403  the shared test cases
from lm_family_cases import make_run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch():
    return "zamba2-1.2b"


@pytest.fixture(scope="module")
def run(arch):
    return make_run(arch)
