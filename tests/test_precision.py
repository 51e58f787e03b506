"""Every float32 contraction on the step, FK and validation paths asks
for full precision: without it a GPU may run float32 products in TF32
(about 3 digits), which moved the f32 engine past the 1e-3 parity bar
against the f64 engine on an H100."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.extend.core as jex_core
from jax import lax

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.ops import quat as qt
from or_cdchomp_jax.parallel.batch import problem_batch_from_grid
from or_cdchomp_jax.tsr import TSR

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _sub_jaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def dot_precisions(closed):
    """precision of every dot_general in a jaxpr, nested ones included."""
    out, todo = [], [closed.jaxpr]
    while todo:
        jaxpr = todo.pop()
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                todo.extend(_sub_jaxprs(v))
    return out


def _world():
    mod = oc.CHOMPModule(dtype=jnp.float32)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def _batch(rn, n=2):
    t = np.asarray(rn.problem.traj, np.float64)
    return problem_batch_from_grid(rn.problem, np.tile(t[0], (n, 1)),
                                   np.tile(t[-1], (n, 1)), rn.engine)


@pytest.mark.parametrize("name,args", [
    ("quat_compose", (jnp.ones((5, 4)), jnp.ones((5, 4)))),
    ("quat_rotate", (jnp.ones((5, 4)), jnp.ones((5, 3)))),
    ("quat_rotate_const", (jnp.ones((5, 4)), np.ones(3))),
    ("quat_compose_const", (jnp.ones((5, 4)), np.ones(4))),
    ("quat_to_R", (jnp.ones((5, 4)),)),
])
def test_quat_structure_contractions_highest(name, args):
    args = tuple(a.astype(jnp.float32) if isinstance(a, jax.Array) else a
                 for a in args)
    fn = getattr(qt, name)
    precs = dot_precisions(jax.make_jaxpr(lambda *a: fn(*a))(*args))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_batch_step_contractions_highest():
    """The SoA batch step (dense metric apply/solve, FK, obstacle and
    self-collision cost, limit repair)."""
    mod = _world()
    rn = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8)]
    assert rn.engine.metric_mode == "dense"
    precs = dot_precisions(jax.make_jaxpr(rn.engine.step_batched)(
        _batch(rn)))
    assert len(precs) >= 4 and all(p == HIGHEST for p in precs), precs


def test_constrained_floating_step_contractions_highest():
    """Floating base + everyn TSR: constraint evaluation, projection
    solve and correction, on both the batch and the per-problem step."""
    mod = _world()
    tsr = TSR.from_matrices(
        np.eye(4), np.eye(4),
        Bw=np.array([[-10, 10], [-10, 10], [-10, 10],
                     [0, 0], [0, 0], [-np.pi, np.pi]]))
    h = mod.create(robot="wam", adofgoal=GOAL, floating_base=True,
                   basegoal=np.array([0.1, 0.05, 0, 0, 0, 0, 1.0]),
                   n_points=6, everyn_tsr=tsr)
    rn = mod.runs[h]
    assert rn.engine.cons.k_total > 0
    for closed in (jax.make_jaxpr(rn.engine.step_batched)(_batch(rn)),
                   jax.make_jaxpr(rn.engine.step)(rn.problem)):
        precs = dot_precisions(closed)
        assert precs and all(p == HIGHEST for p in precs), precs


def test_validation_contractions_highest():
    """gettraj_batch's on-device collision check (scene distances)."""
    from or_cdchomp_jax import api

    mod = _world()
    rn = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8)]
    scenes, inv_poses = [], []
    for b in mod.bodies.values():
        scenes.append(b.scene)
        inv_poses.append(jnp.asarray(
            qt.pose_invert(jnp.asarray(b.pose)), jnp.float32))
    S = rn.engine.n_spheres_total
    x = jnp.zeros((2, 3, S, 3), jnp.float32)
    closed = jax.make_jaxpr(api._traj_collision_batch_jit)(
        scenes, inv_poses, x, jnp.ones(S, jnp.float32),
        jnp.zeros((S, S), bool))
    precs = dot_precisions(closed)
    assert precs and all(p == HIGHEST for p in precs), precs
