"""Test config: by default the tests run on the CPU with 8 virtual
devices, so sharding and collective tests work without a multi-GPU host
(the JAX-idiomatic fake multi-device backend; replaces the reference's
CUDA-twin skipif pattern, SURVEY.md §4). Pallas kernels run in interpret
mode there.

JAX_PLATFORMS picks the platform: unset or "cpu" gives the CPU setup
above (XLA_FLAGS is read when the backend starts, so setting it here is
in time); any other value (e.g. "cuda" on the card, for the `gpu`-marked
tests) is left to JAX.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    assert jax.default_backend() == "cpu", jax.default_backend()
    assert jax.device_count() == 8, jax.devices()
