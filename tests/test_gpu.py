"""Checks that need an NVIDIA GPU (marker `gpu`). Here they skip; on the
card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py

chip_smoke.py runs the same functions (kernel_bench.CARD_CHECKS) as its
last phase."""

import jax
import pytest

from quanta_tpu.benchmarks import kernel_bench

CHECKS = dict(kernel_bench.CARD_CHECKS)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (backend is {jax.default_backend()})")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_card_check(gpu, name):
    CHECKS[name]()
