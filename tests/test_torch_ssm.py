"""Port vs reference: the ssm family (mamba2-2.7b, reduced to 5 layers).

The cases are ``tests/lm_family_cases.py``'s (see there what each holds);
this file gives them the architecture, and holds both families' configs
against the reference's field for field.
"""
import dataclasses

import jax
import pytest
import torch

from lm_family_cases import *  # noqa: F401,F403  the shared test cases
from lm_family_cases import ARCHS, make_run
from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch.configs import base
from repro_torch.launch import steps as ST
from repro_torch.optim import adamw as A


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch():
    return "mamba2-2.7b"


@pytest.fixture(scope="module")
def run(arch):
    return make_run(arch)


def test_configs_equal_reference_field_for_field():
    for arch in ARCHS:
        full, jfull = base.get_config(arch), jbase.get_config(arch)
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull), arch
        red, jred = base.reduced(full), jbase.reduced(jfull)
        assert dataclasses.asdict(red) == dataclasses.asdict(jred), arch
        assert full.param_count() == jfull.param_count()
        assert full.ssm_heads == jfull.ssm_heads
    assert base.get_config("mamba2-2.7b").ssm_heads == 80
    params, state = ST.abstract_state(base.get_config("zamba2-1.2b"),
                                      A.OptConfig())
    jshapes = jax.eval_shape(lambda: JT.init_params(
        jbase.get_config("zamba2-1.2b"), jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in params.parameters()) == sum(
        x.size for x in jax.tree.leaves(jshapes))
    assert state["mu"]["layers/mamba/wz"].shape == (6, 6, 2048, 4096)
    assert state["mu"]["tail/mamba/wz"].shape == (2, 2048, 4096)
