"""URDF loader: structure, FK parity with a hand-built model, spheres."""

import numpy as np
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.models.robot import CompiledFK, RobotModel
from or_cdchomp_jax.models.urdf import parse_urdf, _quat_from_rpy

URDF_2R = """
<robot name="rr">
  <link name="base"/>
  <link name="upper">
    <collision><origin xyz="0 0 0.25"/><geometry><sphere radius="0.07"/></geometry></collision>
  </link>
  <link name="fore">
    <collision><origin xyz="0 0 0.2"/><geometry><sphere radius="0.05"/></geometry></collision>
    <collision><origin xyz="0 0 0.4"/><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="2.0" velocity="1.5"/>
  </joint>
  <joint name="elbow" type="continuous">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="0 0 0.5" rpy="0 0 1.2"/><axis xyz="0 1 0"/>
    <limit velocity="2.5"/>
  </joint>
</robot>
"""


def test_parse_structure():
    m = parse_urdf(URDF_2R)
    assert m.link_names == ("base", "upper", "fore")
    assert m.n_dof == 2
    assert m.dof_names == ("shoulder", "elbow")
    np.testing.assert_allclose(m.dof_limits_lower, [-2.0, -np.inf])
    np.testing.assert_allclose(m.dof_limits_upper, [2.0, np.inf])
    np.testing.assert_allclose(m.dof_max_vel, [1.5, 2.5])
    assert len(m.sphere_radius) == 3
    np.testing.assert_allclose(sorted(m.sphere_radius), [0.04, 0.05, 0.07])
    assert m.ee_link == 2


def test_fk_matches_handbuilt():
    m_urdf = parse_urdf(URDF_2R)
    yaw = 1.2
    m_hand = RobotModel.from_joints(
        "rr", ["base", "upper", "fore"],
        [dict(name="shoulder", parent="base", child="upper",
              type="revolute", origin=[0, 0, 0.1, 0, 0, 0, 1],
              axis=[0, 1, 0], limits=(-2, 2)),
         dict(name="elbow", parent="upper", child="fore", type="revolute",
              origin=[0, 0, 0.5, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2)],
              axis=[0, 1, 0], limits=None)],
        spheres=[("upper", (0, 0, 0.25), 0.07), ("fore", (0, 0, 0.2), 0.05),
                 ("fore", (0, 0, 0.4), 0.04)])
    q = np.array([0.4, -0.7])
    fk_u = CompiledFK(m_urdf)
    fk_h = CompiledFK(m_hand)
    bp = jnp.asarray(np.array([0, 0, 0, 0, 0, 0, 1.0]), dtype=fk_u.dtype)
    lp_u, _ = fk_u.link_poses(jnp.asarray(q, dtype=fk_u.dtype), bp)
    lp_h, _ = fk_h.link_poses(jnp.asarray(q, dtype=fk_h.dtype), bp)
    np.testing.assert_allclose(np.asarray(lp_u), np.asarray(lp_h), atol=1e-6)


def test_rpy_quaternion():
    # single-axis rotations
    np.testing.assert_allclose(
        _quat_from_rpy(np.array([0.6, 0, 0])),
        [np.sin(0.3), 0, 0, np.cos(0.3)], atol=1e-12)
    np.testing.assert_allclose(
        _quat_from_rpy(np.array([0, 0, 0.6])),
        [0, 0, np.sin(0.3), np.cos(0.3)], atol=1e-12)
    # composed rotation matches Rz·Ry·Rx
    from or_cdchomp_jax.tsr import quat_to_R_np
    rpy = np.array([0.3, -0.5, 0.9])
    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == 1:
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    want = rot(2, rpy[2]) @ rot(1, rpy[1]) @ rot(0, rpy[0])
    got = quat_to_R_np(_quat_from_rpy(rpy))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_bad_urdf():
    with pytest.raises(ValueError):
        parse_urdf("<robot name='x'></robot>")          # no links
    with pytest.raises(ValueError):
        parse_urdf("""<robot name="x"><link name="a"/><link name="b"/>
          <joint name="j" type="planar">
            <parent link="a"/><child link="b"/></joint></robot>""")
    with pytest.raises(ValueError):   # two roots
        parse_urdf("""<robot name="x"><link name="a"/><link name="b"/>
          <link name="c"/>
          <joint name="j" type="fixed">
            <parent link="a"/><child link="b"/></joint></robot>""")


def test_urdf_robot_plans():
    """End-to-end: a URDF robot goes through create/iterate."""
    m = parse_urdf(URDF_2R)
    mod = oc.CHOMPModule()
    mod.add_kinbody(oc.api.KinBody("box", oc.Scene.build(
        boxes=[((0.4, 0.0, 0.5, 0, 0, 0, 1), (0.1, 0.1, 0.1))])))
    r = oc.api.Robot("rr", m, q_active=np.array([0.1, 0.2]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="box", cube_extent=0.1)
    r.enabled = True
    h = mod.create(robot="rr", adofgoal=[1.0, -0.5], n_points=8,
                   lambda_=100.0)
    cost = mod.iterate(run=h, n_iter=3)
    assert np.isfinite(cost)
