"""OpenRAVE robot-XML ingestion (models/orxml.py).

The reference's robot format is OpenRAVE XML
(scripts/barrettwam_withspheres.robot.xml).  The parser converts its
body/joint/anchor semantics into RobotModel's URDF-style chain; these
tests validate against an INDEPENDENT homogeneous-matrix oracle that
implements OpenRAVE's semantics directly (bodies posed in world at
zero configuration; each joint rotates its subtree about its
zero-config world axis through its world anchor).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from or_cdchomp_jax.models.orxml import parse_robot_xml
from or_cdchomp_jax.models.robot import CompiledFK

MINI = """<?xml version="1.0"?>
<Robot name="mini">
 <KinBody>
  <Body name="base" type="static"/>
  <Body name="link1">
    <offsetfrom>base</offsetfrom>
    <Translation>0 0 0.3</Translation>
  </Body>
  <Body name="link2">
    <offsetfrom>link1</offsetfrom>
    <Translation>0.1 0 0.2</Translation>
    <RotationAxis>0 1 0 90</RotationAxis>
  </Body>
  <Body name="tool">
    <offsetfrom>link2</offsetfrom>
    <Translation>0.15 0 0</Translation>
    <quat>0.9238795 0 0 0.3826834</quat>
  </Body>
  <Joint name="j1" type="hinge">
    <Body>base</Body><Body>link1</Body>
    <offsetfrom>link1</offsetfrom>
    <axis>0 0 1</axis>
    <limitsdeg>-170 170</limitsdeg>
    <maxvel>2.0</maxvel>
  </Joint>
  <Joint name="j2" type="hinge">
    <Body>link1</Body><Body>link2</Body>
    <offsetfrom>link2</offsetfrom>
    <axis>0 1 0</axis>
    <anchor>0 0 -0.05</anchor>
    <limits>-90 90</limits>
  </Joint>
  <Joint name="jt" type="hinge" enable="false">
    <Body>link2</Body><Body>tool</Body>
    <limits>0 0</limits>
  </Joint>
  <orcdchomp>
    <spheres>
      <sphere link="link1" pos="0 0 0.1" radius="0.05"/>
      <sphere link="link2" pos="0.05 0 0" radius="0.04"/>
      <sphere link="tool" pos="0.02 0 0" radius="0.03"/>
    </spheres>
  </orcdchomp>
 </KinBody>
 <Manipulator name="arm">
   <effector>tool</effector>
   <Translation>0 0 0.1</Translation>
 </Manipulator>
</Robot>
"""


# ---- independent oracle: OpenRAVE semantics with 4x4 matrices ----------

def _T(translation=(0, 0, 0), R=None):
    M = np.eye(4)
    M[:3, 3] = translation
    if R is not None:
        M[:3, :3] = R
    return M


def _rot_axis(axis, ang):
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _mini_oracle(q):
    """World transforms of every body for config q = (q1, q2)."""
    # zero-config world poses straight from the XML text
    T_base = np.eye(4)
    T_l1 = _T((0, 0, 0.3))
    T_l2 = T_l1 @ _T((0.1, 0, 0.2), _rot_axis((0, 1, 0), np.pi / 2))
    # OpenRAVE <quat> is w x y z: (0.9238795, 0, 0, 0.3826834) =
    # rotation of 45deg about z
    T_tool = T_l2 @ _T((0.15, 0, 0), _rot_axis((0, 0, 1), np.pi / 4))

    def joint_world(T_ref, axis_local, anchor_local):
        a_w = T_ref[:3, :3] @ np.asarray(axis_local, float)
        p_w = T_ref[:3, :3] @ np.asarray(anchor_local, float) + T_ref[:3, 3]
        return a_w, p_w

    # j1: axis z in link1 frame, anchor at link1 origin
    a1, p1 = joint_world(T_l1, (0, 0, 1), (0, 0, 0))
    R1 = _T(p1) @ _T((0, 0, 0), _rot_axis(a1, q[0])) @ _T(-p1)
    # j2: axis y in link2 frame, anchor (0,0,-0.05) in link2 frame
    a2, p2 = joint_world(T_l2, (0, 1, 0), (0, 0, -0.05))
    R2 = _T(p2) @ _T((0, 0, 0), _rot_axis(a2, q[1])) @ _T(-p2)

    W_l1 = R1 @ T_l1
    W_l2 = R1 @ R2 @ T_l2
    W_tool = R1 @ R2 @ T_tool
    return {"base": T_base, "link1": W_l1, "link2": W_l2, "tool": W_tool}


SPHERES = {"link1": (0, 0, 0.1), "link2": (0.05, 0, 0),
           "tool": (0.02, 0, 0)}


def test_fk_matches_openrave_semantics():
    model = parse_robot_xml(MINI)
    assert model.n_dof == 2
    fk = CompiledFK(model)
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.uniform(-1.2, 1.2, size=2)
        x = np.asarray(fk.sphere_positions_jit(
            jnp.asarray(q, fk.dtype),
            jnp.asarray(np.array([0, 0, 0, 0, 0, 0, 1.0]), fk.dtype)))
        W = _mini_oracle(q)
        for i, (link, pos) in enumerate(
                [("link1", SPHERES["link1"]), ("link2", SPHERES["link2"]),
                 ("tool", SPHERES["tool"])]):
            expect = W[link][:3, :3] @ np.asarray(pos) + W[link][:3, 3]
            np.testing.assert_allclose(x[i], expect, atol=1e-6)


def test_limits_and_metadata():
    model = parse_robot_xml(MINI)
    # limitsdeg -170..170 → radians; <limits> on a hinge is degrees too
    np.testing.assert_allclose(model.dof_limits_lower,
                               [np.deg2rad(-170), np.deg2rad(-90)])
    np.testing.assert_allclose(model.dof_limits_upper,
                               [np.deg2rad(170), np.deg2rad(90)])
    np.testing.assert_allclose(model.dof_max_vel, [2.0, 1.0])
    assert model.dof_names == ("j1", "j2")
    # fixed (enable=false) joint keeps the tool attached but undofed
    assert "tool" in model.link_names
    assert model.ee_link == model.link_names.index("tool")
    # radii parsed through the kdata path
    np.testing.assert_allclose(model.sphere_radius, [0.05, 0.04, 0.03])


def test_active_selection():
    model = parse_robot_xml(MINI, active=["j2"])
    assert model.n_dof == 1
    np.testing.assert_allclose(model.dof_limits_lower, [np.deg2rad(-90)])


def test_manipulator_default_active_excludes_offchain_joints():
    """active=None with a <Manipulator> selects the arm chain only
    (GetArmIndices semantics) — an enabled joint off the effector path
    (a 'finger') is frozen, not a DOF."""
    xml = MINI.replace(
        "<orcdchomp>",
        """<Body name="finger">
             <offsetfrom>link2</offsetfrom>
             <Translation>0.05 0.05 0</Translation>
           </Body>
           <Joint name="jf" type="hinge">
             <Body>link2</Body><Body>finger</Body>
             <offsetfrom>finger</offsetfrom>
             <axis>0 0 1</axis>
             <limitsdeg>0 90</limitsdeg>
           </Joint>
           <orcdchomp>""")
    model = parse_robot_xml(xml)
    assert model.dof_names == ("j1", "j2")    # jf frozen
    assert "finger" in model.link_names
    # explicit active still wins
    model2 = parse_robot_xml(xml, active=["j1", "j2", "jf"])
    assert model2.n_dof == 3


def test_spheres_from_included_file(tmp_path):
    """<orcdchomp><spheres> payloads inside a resolved <KinBody file=…>
    include must be collected (OpenRAVE merges included content)."""
    inner = """<KinBody name="inner">
      <Body name="base"/>
      <Body name="l1">
        <offsetfrom>base</offsetfrom><Translation>0 0 0.5</Translation>
      </Body>
      <Joint name="j1" type="hinge">
        <Body>base</Body><Body>l1</Body>
        <offsetfrom>l1</offsetfrom><axis>0 0 1</axis>
        <limitsdeg>-90 90</limitsdeg>
      </Joint>
      <orcdchomp><spheres>
        <sphere link="l1" pos="0 0 0.1" radius="0.07"/>
      </spheres></orcdchomp>
    </KinBody>"""
    (tmp_path / "inner.xml").write_text(inner)
    outer = """<Robot name="r"><KinBody>
      <KinBody file="inner.xml"/>
    </KinBody></Robot>"""
    model = parse_robot_xml(outer, search_paths=[str(tmp_path)])
    np.testing.assert_allclose(model.sphere_radius, [0.07])


def test_malformed_spheres_raise():
    xml = MINI.replace('pos="0 0 0.1"', 'pos="0 0"')
    with pytest.raises(ValueError):
        parse_robot_xml(xml)


def test_file_include_requires_search_path(tmp_path):
    xml = """<Robot name="r"><KinBody>
      <KinBody file="robots/wam7.kinbody.xml"/>
    </KinBody></Robot>"""
    with pytest.raises(FileNotFoundError, match="external OpenRAVE"):
        parse_robot_xml(xml)


def test_file_include_resolves(tmp_path):
    inner = """<KinBody name="inner">
      <Body name="base"/>
      <Body name="l1">
        <offsetfrom>base</offsetfrom><Translation>0 0 0.5</Translation>
      </Body>
      <Joint name="j1" type="hinge">
        <Body>base</Body><Body>l1</Body>
        <offsetfrom>l1</offsetfrom><axis>0 0 1</axis>
        <limitsdeg>-90 90</limitsdeg>
      </Joint>
    </KinBody>"""
    (tmp_path / "inner.xml").write_text(inner)
    outer = """<Robot name="r"><KinBody>
      <KinBody file="inner.xml"/>
    </KinBody></Robot>"""
    model = parse_robot_xml(outer, search_paths=[str(tmp_path)])
    assert model.n_dof == 1
    assert model.link_names == ("base", "l1")


def test_end_to_end_solve_from_xml():
    """An XML-loaded robot drives the full module pipeline."""
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot

    model = parse_robot_xml(MINI)
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("ball", oc.Scene.build(
        spheres=[((0.3, 0.0, 0.45), 0.08)])))
    r = Robot("mini", model, q_active=np.array([0.3, 0.4]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="ball", cube_extent=0.06)
    r.enabled = True
    traj = mod.runchomp(robot="mini", n_iter=30, lambda_=100.0,
                        obs_factor=200.0, n_points=11,
                        adofgoal=[-0.5, -0.3],
                        no_collision_exception=True)
    assert traj.positions.shape[1] == 2
