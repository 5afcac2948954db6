"""Test configuration: CPU backend with 8 virtual devices and x64 numerics.

Mirrors the reference's CPU-runnable validation strategy (SURVEY.md §4):
multi-device sharding is exercised on a simulated 8-device mesh, and numerics
run in float64 for exact parity with the C implementation. The backend is
pinned through jax.config (effective until first backend use), so the tests
stay on the CPU even where a GPU is present. Checks that need the GPU run in
chip_smoke.py; pytest tests marked `gpu` skip here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
