"""Regression: computedistancefield must include the named kinbody.

The reference's probe-cube voxelization collision-checks the whole env;
the named kinbody only anchors the grid (its AABB + padding, moving
with it) and contributes occupancy like any other *enabled* body
(test_wam7.py:76-79 names the *disabled* robot so the field covers the
table+mug).  Round-2 bug: the named body was unconditionally excluded,
so a field built around a lone enabled obstacle came out empty
(all-+inf) and obstacle costs silently vanished.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _world():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START.copy())
    mod.add_robot(r)
    return mod, r


def test_named_enabled_body_is_in_its_own_field():
    mod, r = _world()
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.05)
    r.enabled = True
    d = np.asarray(mod.sdfs[0].grid.data)
    assert np.isfinite(d).all(), "single-obstacle field must be finite"
    assert (d < 0).any(), "interior cells must be negative"
    assert (d > 0).any(), "exterior cells must be positive"


def test_disabled_bodies_are_excluded():
    mod, r = _world()
    r.enabled = False
    mod.bodies["table"].enabled = False
    mod.add_kinbody(KinBody("anchor", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.3, 0.4, 0.4))])))
    mod.bodies["anchor"].enabled = False
    # nothing enabled: the reference's voxelization hits nothing and the
    # whole grid is "exterior at infinite distance" (all +inf)
    mod.computedistancefield(kinbody="anchor", cube_extent=0.1)
    d = np.asarray(mod.sdfs[0].grid.data)
    assert np.isinf(d).all()


def test_obstacle_cost_is_nonzero_through_the_field():
    mod, r = _world()
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.05)
    r.enabled = True
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=11)
    rn = mod.runs[h]
    _, costs = rn.engine.step(rn.problem)
    assert float(costs[1]) > 0.0, "obstacle cost must see the table"


def test_enabled_robot_contributes_to_other_fields():
    """A second robot's spheres are obstacles in the field (the env
    collision checker sees enabled robots too)."""
    mod, r = _world()
    r.enabled = True  # robot left enabled during the build
    r.pose = np.array([0.5, 0.0, 0.63, 0, 0, 0, 1.0])  # on the table
    mod.computedistancefield(kinbody="table", cube_extent=0.05)
    d_with = np.asarray(mod.sdfs[0].grid.data)

    mod2, r2 = _world()
    r2.enabled = False
    mod2.computedistancefield(kinbody="table", cube_extent=0.05)
    d_without = np.asarray(mod2.sdfs[0].grid.data)
    assert (d_with <= d_without + 1e-12).all()
    assert (d_with < d_without - 1e-9).any(), \
        "enabled robot spheres must add occupancy"
