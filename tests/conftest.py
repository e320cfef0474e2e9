"""Test harness config: JAX on the CPU with 8 virtual devices, so sharding
tests exercise a multi-device mesh on any host and Pallas kernels run in
interpret mode.

JAX_PLATFORMS, when set, picks the platforms instead: tests marked `gpu`
run on the card with JAX_PLATFORMS=cuda,cpu (see pytest.ini).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)
