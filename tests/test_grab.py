"""Grabbed-body handling: spheres re-root to the grabbing link and the
body stops being a world obstacle (orcdchomp_mod.cpp:2200-2208)."""

import numpy as np
import jax.numpy as jnp

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.models.robot import CompiledFK


def _setup():
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    return mod, r


def test_grab_appends_spheres_and_moves_with_link():
    mod, r = _setup()
    n0 = len(r.model.sphere_radius)
    mug = KinBody("mug", oc.Scene.build(spheres=[((0.0, 0.0, 0.05), 0.04)]))
    # place the mug exactly at the last link's current world origin
    fk = CompiledFK(r.model)
    lp, _ = fk.link_poses(jnp.asarray(r.q_active, dtype=fk.dtype),
                          base_pose=jnp.asarray(r.pose, dtype=fk.dtype))
    ee = np.asarray(lp)[-1].astype(np.float64)
    mug.pose = ee.copy()
    mod.add_kinbody(mug)

    last_link = r.model.link_names[-1]
    r.grab(mug, last_link)
    assert len(r.model.sphere_radius) == n0 + 1
    assert mug.grabbed_by == "wam"
    # its sphere now tracks the link
    x, rad = r.sphere_world()
    np.testing.assert_allclose(rad[-1], 0.04, atol=1e-6)
    # move the joints; the grabbed sphere must move too
    x_before = x[-1].copy()
    r.q_active = r.q_active + 0.3
    x2, _ = r.sphere_world()
    assert np.linalg.norm(x2[-1] - x_before) > 1e-3

    # the grabbed body stays an ordinary enabled kinbody in the world
    # (OpenRAVE CheckCollision sees it) but at its *carried* pose
    scenes, poses = mod._world_occupancy_scene()
    assert len(scenes) == 3   # table + mug (carried) + robot spheres
    np.testing.assert_allclose(
        poses[1], r.grabbed_body_pose("mug"), atol=1e-6)

    r.release(mug)
    assert len(r.model.sphere_radius) == n0
    assert mug.grabbed_by is None


def test_release_updates_body_pose_to_carried_location():
    """Released bodies keep the world transform the link carried them
    to, not their grab-time pose (OpenRAVE Release semantics)."""
    mod, r = _setup()
    mug = KinBody("mug", oc.Scene.build(spheres=[((0, 0, 0), 0.03)]))
    fk = CompiledFK(r.model)
    lp, _ = fk.link_poses(jnp.asarray(r.q_active, dtype=fk.dtype),
                          base_pose=jnp.asarray(r.pose, dtype=fk.dtype))
    mug.pose = np.asarray(lp)[-1].astype(np.float64).copy()
    mod.add_kinbody(mug)
    pose_at_grab = mug.pose.copy()
    r.grab(mug, r.model.link_names[-1])
    r.q_active = r.q_active + 0.4          # carry the mug somewhere else
    carried = r.grabbed_body_pose("mug")
    r.release(mug)
    np.testing.assert_allclose(mug.pose, carried, atol=1e-6)
    assert np.linalg.norm(mug.pose[:3] - pose_at_grab[:3]) > 1e-3


def test_release_order_with_multiple_grabs():
    """Releasing an earlier-grabbed body must not orphan or shift a
    later-grabbed body's spheres (owner-tag regression: grab A(2)+B(1),
    release A then B → exactly the original sphere count)."""
    mod, r = _setup()
    n0 = len(r.model.sphere_radius)
    a = KinBody("a", oc.Scene.build(
        spheres=[((0, 0, 0), 0.02), ((0, 0, 0.05), 0.03)]))
    b = KinBody("b", oc.Scene.build(spheres=[((0, 0, 0), 0.04)]))
    mod.add_kinbody(a)
    mod.add_kinbody(b)
    link = r.model.link_names[-1]
    r.grab(a, link)
    r.grab(b, link)
    assert len(r.model.sphere_radius) == n0 + 3
    r.release(a)
    assert len(r.model.sphere_radius) == n0 + 1
    # the remaining grabbed sphere is b's (radius 0.04), not a leftover
    np.testing.assert_allclose(float(r.model.sphere_radius[-1]), 0.04,
                               atol=1e-9)
    r.release(b)
    assert len(r.model.sphere_radius) == n0
    assert a.grabbed_by is None and b.grabbed_by is None


def test_other_robots_grabs_stay_obstacles():
    """A body held by robot X remains an obstacle when planning or
    collision-checking robot Y."""
    mod, rx = _setup()
    ry = Robot("wam2", oc.wam7(), q_active=np.zeros(7))
    mod.add_robot(ry)
    mug = KinBody("mug", oc.Scene.build(spheres=[((0, 0, 0), 0.03)]))
    mod.add_kinbody(mug)
    rx.grab(mug, rx.model.link_names[-1])
    # occupancy for an SDF build: mug still present while held
    scenes, poses = mod._world_occupancy_scene()
    assert len(scenes) == 4   # table + mug + two robots' sphere scenes


def test_grab_twice_raises():
    mod, r = _setup()
    mug = KinBody("mug", oc.Scene.build(spheres=[((0, 0, 0), 0.03)]))
    mod.add_kinbody(mug)
    r.grab(mug, r.model.link_names[-1])
    try:
        r.grab(mug, r.model.link_names[-1])
        assert False, "expected RuntimeError"
    except RuntimeError:
        pass


def test_check_exclude_uses_reference_config():
    """Overlap exclusions are computed at the construction-time
    reference config, not at whatever config the first collision check
    happens to run at (a colliding transient config must not whitelist
    genuinely-colliding pairs)."""
    q0 = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    q1 = np.array([0.0, 2.0, 0.0, 3.0, 0.0, 1.5, 0.0])
    mod, r = _setup()                     # constructed at q0
    # masks computed at q0 vs q1 genuinely differ for these configs
    m_at_q0 = Robot("a", oc.wam7(), q_active=q0).check_exclude_mask()
    m_at_q1 = Robot("b", oc.wam7(), q_active=q1).check_exclude_mask()
    assert not np.array_equal(m_at_q0, m_at_q1)
    # move the robot somewhere else before the first check: the mask
    # must still reflect the construction-time reference config
    r.q_active = q1.copy()
    np.testing.assert_array_equal(r.check_exclude_mask(), m_at_q0)


def test_check_exclude_invalidated_by_grab_release():
    """grab()/release() explicitly invalidate the cached exclusions —
    including the same-sphere-count release-A-grab-B case that a
    count-keyed cache would silently reuse."""
    mod, r = _setup()
    base_mask = r.check_exclude_mask()
    n0 = base_mask.shape[0]
    link_a = r.model.link_names[2]
    link_b = r.model.link_names[-1]
    a = KinBody("a", oc.Scene.build(spheres=[((0, 0, 0), 0.03)]))
    b = KinBody("b", oc.Scene.build(spheres=[((0, 0, 0), 0.03)]))
    mod.add_kinbody(a)
    mod.add_kinbody(b)
    r.grab(a, link_a)
    assert r._check_exclude is None       # invalidated, not stale
    mask_a = r.check_exclude_mask().copy()
    assert mask_a.shape[0] == n0 + 1
    r.release(a)
    assert r._check_exclude is None
    r.grab(b, link_b)                     # same sphere count as with a
    mask_b = r.check_exclude_mask()
    assert mask_b.shape[0] == n0 + 1
    # b hangs on a different link: its adjacency row must differ from
    # a's — a count-keyed cache would have returned mask_a verbatim
    assert not np.array_equal(mask_a, mask_b)


def test_bounding_spheres_cover_primitives():
    sc = oc.Scene.build(
        boxes=[((1.0, 0, 0, 0, 0, 0, 1), (0.1, 0.2, 0.3))],
        spheres=[((0, 1.0, 0), 0.5)],
        cylinders=[((0, 0, 2.0, 0, 0, 0, 1), 0.2, 0.4)])
    centers, radii = sc.bounding_spheres()
    assert centers.shape == (3, 3)
    np.testing.assert_allclose(radii[0], 0.5)                      # sphere
    np.testing.assert_allclose(radii[1], np.linalg.norm([0.1, 0.2, 0.3]))
    np.testing.assert_allclose(radii[2], np.hypot(0.2, 0.4))
