"""Test config: the suite runs on the CPU with 8 virtual devices, so the
sharding tests need no accelerator:

    JAX_PLATFORMS=cpu python -m pytest tests/ -q

The platform is forced here, before any backend starts, unless
`JAX_PLATFORMS` names the CUDA backend.  That is how `chip_smoke.py` runs
the tests marked `gpu` in its own process on the card (its phase 5); on the
CPU those tests skip through their `gpu` fixture.
"""

import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags +
                                   " --xla_force_host_platform_device_count=8")

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)
