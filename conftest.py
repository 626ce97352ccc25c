"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip sharding logic is validated on host CPU devices (the reference has
no distributed story to test; SURVEY.md §4 implication (d)).

The platform is the CPU unless JAX_PLATFORMS names another (the `gpu`-marked
tests run on a card with JAX_PLATFORMS=cuda); it is pinned through
jax.config as well as the environment.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
