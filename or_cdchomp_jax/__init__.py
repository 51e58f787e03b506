"""or_cdchomp_jax: a CHOMP motion-planning engine for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
personalrobotics/or_cdchomp (OpenRAVE plugin around libcd's cd_chomp):
covariant trajectory optimization with signed-distance-field obstacle
costs, self-collision costs, TSR constraints, joint limits, HMC
restarts, and batched solves sharded over accelerator device meshes.

Reference parity targets are cited throughout as ``file:line`` into the
reference tree (e.g. ``chomp.c:430-683``).
"""

__version__ = "0.1.0"

from or_cdchomp_jax.api import CHOMPModule, KinBody, Robot  # noqa: E402,F401
from or_cdchomp_jax.models.orxml import parse_robot_xml  # noqa: E402,F401
from or_cdchomp_jax.models.urdf import load_urdf, parse_urdf  # noqa: E402,F401
from or_cdchomp_jax.models.wam7 import wam7  # noqa: E402,F401
from or_cdchomp_jax.ops.voxelize import Scene  # noqa: E402,F401
from or_cdchomp_jax.tsr import TSR  # noqa: E402,F401
