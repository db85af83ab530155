"""Test configuration: run JAX on a virtual multi-device CPU mesh.

The tests run on the CPU; sharding/collective logic is exercised on 8
virtual CPU devices (SURVEY.md section 4e). The platform is forced through
jax.config before any backend initialization, so the tests stay on the CPU
even where JAX would pick an accelerator by default.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
