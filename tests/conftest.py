"""Test configuration: run the suite on CPU with 8 virtual devices so
sharding/collective tests work without accelerator hardware.

The platform is set through jax.config as well as the environment, since
jax may already have been imported (and read JAX_PLATFORMS) by the time
this file runs.  Nothing here needs the GPU: the checks on the card are
the phases of `chip_smoke.py`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
# float64 for numerical-accuracy assertions; tests exercising the fp32
# production path request float32 arrays explicitly.
jax.config.update("jax_enable_x64", True)
