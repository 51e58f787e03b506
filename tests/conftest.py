"""Test configuration: CPU backend with 8 virtual devices + x64.

The reference implementation is all float64 (libcd uses double
throughout); parity tests run the JAX build in float64 on CPU, while
f32 tolerance tests exercise the production dtype.  Sharding tests use
the 8-device virtual CPU mesh.

The platform is chosen through jax.config before any backend starts.
The suite runs on the CPU unless JAX_PLATFORMS names another platform:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests
marked ``gpu`` on a card.
"""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
