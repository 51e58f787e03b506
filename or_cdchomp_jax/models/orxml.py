"""OpenRAVE robot/kinbody XML → RobotModel.

The reference's de-facto robot format is OpenRAVE XML: its demo loads
``scripts/barrettwam_withspheres.robot.xml`` (a ``<Robot>`` wrapping
``<KinBody>`` bodies/joints plus the ``<orcdchomp><spheres>`` payload,
test_wam7.py:38).  This module ingests the kinematics subset of that
format directly:

 - ``<Body name=…>`` with ``<offsetfrom>``, ``<Translation>``,
   ``<RotationAxis x y z deg>``, ``<quat w x y z>``, ``<rotationmat>``
   (transform elements compose in document order; all body transforms
   define the zero-configuration world pose)
 - ``<Joint name=… type="hinge|slider" enable="…">`` with two
   ``<Body>`` children (parent first), ``<offsetfrom>``, ``<axis>``,
   ``<anchor>``, ``<limits>`` (degrees for hinge — OpenRAVE's
   convention), ``<limitsdeg>``, ``<limitsrad>``, ``<maxvel>`` (rad/s),
   ``<maxveldeg>``; ``enable="false"`` ⇒ fixed
 - ``<orcdchomp><spheres>`` (orcdchomp_kdata.cpp:65-98 — parsed by
   models/kdata.py)
 - ``<Manipulator>`` ``<effector>`` + ``<Translation>`` → ee link/tool

Anchored joints: OpenRAVE rotates about an ``<anchor>`` point rather
than the child-body origin.  The conversion re-roots the child frame
AT the anchor (a pure translation change of frame): the joint origin
gains +anchor, and everything expressed in the old child frame —
sphere positions, descendant joint anchors/origins via the body world
poses — is shifted by −anchor.  Exact, no extra links.

``<KinBody file="…">`` includes reference OpenRAVE's external data
files, which do not ship with the reference repository; they raise a
clear error (pass ``search_paths`` to resolve them from disk).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from or_cdchomp_jax.models.kdata import parse_spheres_xml
from or_cdchomp_jax.models.robot import RobotModel
from or_cdchomp_jax.utils import np_pose


def _quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = axis / n
    s = np.sin(angle / 2.0)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s,
                     np.cos(angle / 2.0)])


def _quat_from_R(R):
    # Shepperd's method
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2.0
        q = np.zeros(4)
        q[i] = s / 4.0
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _floats(text):
    return [float(v) for v in text.replace(",", " ").split()]


def _pose_of_elem(el, body_world):
    """Accumulate transform child elements of ``el`` in document order
    into a pose7, resolving <offsetfrom> against known body poses.

    Runs in pass 1 (before any joint re-roots a frame), so body poses
    here are exactly the frames the XML coordinates were written in.
    """
    pose = np_pose.POSE_ID.copy()
    base = np_pose.POSE_ID.copy()
    for ch in el:
        tag = ch.tag.lower()
        if tag == "offsetfrom":
            ref = ch.text.strip()
            if ref not in body_world:
                raise ValueError(
                    f"<offsetfrom>{ref}</offsetfrom> references an "
                    "unknown body (bodies must be declared first)")
            base = body_world[ref].copy()
        elif tag == "translation":
            v = _floats(ch.text)
            pose = np_pose.compose(
                pose, np.array(v + [0, 0, 0, 1], dtype=np.float64))
        elif tag == "rotationaxis":
            v = _floats(ch.text)
            q = _quat_from_axis_angle(v[:3], np.deg2rad(v[3]))
            pose = np_pose.compose(
                pose, np.concatenate([[0, 0, 0], q]))
        elif tag == "quat":
            w, x, y, z = _floats(ch.text)          # OpenRAVE order: wxyz
            pose = np_pose.compose(
                pose, np.array([0, 0, 0, x, y, z, w], dtype=np.float64))
        elif tag == "rotationmat":
            v = _floats(ch.text)
            q = _quat_from_R(np.asarray(v).reshape(3, 3))
            pose = np_pose.compose(pose, np.concatenate([[0, 0, 0], q]))
    return np_pose.compose(base, pose)


def parse_robot_xml(source, *, name=None, active=None, search_paths=()):
    """Parse OpenRAVE robot/kinbody XML into a :class:`RobotModel`.

    source: XML string or a path to a ``.xml`` file.
    active: active joint names (defaults to the manipulator's arm
      chain if a <Manipulator> is present, else all enabled joints).
    search_paths: directories for resolving ``<KinBody file=…>``
      includes.
    """
    if isinstance(source, (str, os.PathLike)) and os.path.exists(source):
        with open(source) as f:
            text = f.read()
        search_paths = tuple(search_paths) + (os.path.dirname(
            os.path.abspath(source)),)
    else:
        text = source
    root = ET.fromstring(text)
    if root.tag.lower() not in ("robot", "kinbody"):
        raise ValueError(f"expected <Robot> or <KinBody>, got <{root.tag}>")
    rname = name or root.attrib.get("name", "robot")

    bodies = []          # (name, element) in document order
    joints = []          # joint elements in document order
    manip = None
    sphere_sources = [root]   # roots whose <orcdchomp><spheres> count

    def walk(el):
        nonlocal manip
        for ch in el:
            tag = ch.tag.lower()
            if tag == "kinbody":
                if "file" in ch.attrib:
                    path = None
                    for d in search_paths:
                        cand = os.path.join(d, ch.attrib["file"])
                        if os.path.exists(cand):
                            path = cand
                            break
                    if path is None:
                        raise FileNotFoundError(
                            f"<KinBody file={ch.attrib['file']!r}> is an "
                            "external OpenRAVE data file; pass "
                            "search_paths=[...] so it can be resolved")
                    sub = ET.parse(path).getroot()
                    sphere_sources.append(sub)
                    walk(sub)
                walk(ch)
            elif tag == "body":
                if "name" in ch.attrib:
                    bodies.append((ch.attrib["name"], ch))
            elif tag == "joint":
                joints.append(ch)
            elif tag == "manipulator":
                manip = ch

    walk(root)
    if not bodies:
        raise ValueError("no <Body> elements found")

    # pass 1: world poses at zero configuration, document order
    body_world = {}
    frame_shift = {}     # body → anchor shift applied to its frame
    for bname, el in bodies:
        body_world[bname] = _pose_of_elem(el, body_world)

    # pass 2: joints
    jrows = []
    link_parent = {}
    for el in joints:
        jname = el.attrib.get("name", f"joint{len(jrows)}")
        jtype = el.attrib.get("type", "hinge").lower()
        enabled = el.attrib.get("enable", "true").lower() != "false"
        pair = []
        offsetfrom = None
        axis = np.array([0.0, 0.0, 1.0])
        anchor = np.zeros(3)
        limits = None
        max_vel = 1.0
        for ch in el:
            tag = ch.tag.lower()
            if tag == "body":
                pair.append(ch.text.strip())
            elif tag == "offsetfrom":
                offsetfrom = ch.text.strip()
            elif tag == "axis":
                axis = np.asarray(_floats(ch.text))
            elif tag == "anchor":
                anchor = np.asarray(_floats(ch.text))
            elif tag in ("limits", "limitsdeg"):
                lo, hi = _floats(ch.text)[:2]
                if jtype in ("hinge", "revolute"):
                    lo, hi = np.deg2rad(lo), np.deg2rad(hi)
                limits = (lo, hi)
            elif tag == "limitsrad":
                lo, hi = _floats(ch.text)[:2]
                limits = (lo, hi)
            elif tag == "maxvel":
                max_vel = float(ch.text.strip())
            elif tag == "maxveldeg":
                max_vel = np.deg2rad(float(ch.text.strip()))
        if len(pair) != 2:
            raise ValueError(f"joint {jname} needs two <Body> children")
        pname, cname = pair
        if cname in link_parent:
            raise ValueError(f"body {cname} has two parent joints")
        link_parent[cname] = pname
        ref = offsetfrom or cname
        if ref not in body_world:
            raise ValueError(f"joint {jname}: unknown frame {ref!r}")
        # axis/anchor to world, then into the child frame
        T_ref = body_world[ref]
        sh = frame_shift.get(ref)
        if sh is not None:
            T_ref = np_pose.compose(
                T_ref, np.concatenate([-sh, [0, 0, 0, 1]]))
        axis_w = np_pose.rotate(T_ref[3:], axis)
        anchor_w = np_pose.apply(T_ref, anchor)
        T_c = body_world[cname]
        inv_c = np_pose.invert(T_c)
        axis_c = np_pose.rotate(inv_c[3:], axis_w)
        anchor_c = np_pose.apply(inv_c, anchor_w)
        if jtype in ("hinge", "revolute") and np.linalg.norm(anchor_c) > 1e-12:
            # re-root the child frame at the anchor so the motion
            # rotates about the child-frame origin (RobotModel's FK
            # convention); sphere/descendant coordinates get −anchor
            frame_shift[cname] = anchor_c.copy()
            body_world[cname] = np_pose.compose(
                T_c, np.concatenate([anchor_c, [0, 0, 0, 1]]))
        jrows.append(dict(
            name=jname, parent=pname, child=cname,
            type=("fixed" if not enabled
                  else ("prismatic" if jtype in ("slider", "prismatic")
                        else "revolute")),
            axis=axis_c, limits=limits, max_vel=max_vel))

    # topological link order from the parent map
    all_names = [b for b, _ in bodies]
    roots = [b for b in all_names if b not in link_parent]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root body, got {roots}")
    children = {}
    for c, p in link_parent.items():
        children.setdefault(p, []).append(c)
    order = [roots[0]]
    stack = [roots[0]]
    while stack:
        b = stack.pop(0)
        for c in children.get(b, []):
            order.append(c)
            stack.append(c)
    if len(order) != len(all_names):
        orphans = sorted(set(all_names) - set(order))
        raise ValueError(f"bodies not connected to the root: {orphans}")

    # joint origins in the (possibly re-rooted) frames
    for j in jrows:
        T_p = body_world[j["parent"]]
        T_c = body_world[j["child"]]
        j["origin"] = np_pose.compose(np_pose.invert(T_p), T_c)

    # root shift: express everything relative to the root's world pose
    # (RobotModel poses the root at the Robot's world pose at runtime)

    # spheres, from the top-level document AND every resolved
    # <KinBody file=…> include (OpenRAVE merges included kinbody
    # content), shifted into re-rooted frames.  Only the benign
    # "no <orcdchomp> tag" case is tolerated — a malformed sphere
    # block must not silently yield a collision-blind model.
    sph = []
    for src in sphere_sources:
        try:
            sph.extend(parse_spheres_xml(
                ET.tostring(src, encoding="unicode")))
        except ValueError as exc:
            if "no spheres" not in str(exc):
                raise
    sph_rows = []
    for link, pos, radius in sph:
        p = np.asarray(pos, dtype=np.float64)
        sh = frame_shift.get(link)
        if sh is not None:
            p = p - sh
        sph_rows.append((link, tuple(p), radius))

    # manipulator → ee link + tool transform (+ arm-chain base)
    ee_link = None
    ee_origin = None
    manip_base = None
    if manip is not None:
        for ch in manip:
            tag = ch.tag.lower()
            if tag == "effector":
                ee_link = ch.text.strip()
            elif tag == "base":
                manip_base = ch.text.strip()
            elif tag == "translation":
                v = _floats(ch.text)
                ee_origin = np.array(v + [0, 0, 0, 1], dtype=np.float64)
        if ee_link is not None and ee_link in frame_shift:
            if ee_origin is None:
                # the effector frame was re-rooted at its joint anchor;
                # OpenRAVE's effector point is the BODY origin, which
                # now sits at −anchor in the re-rooted frame
                ee_origin = np.array([0, 0, 0, 0, 0, 0, 1.0])
            ee_origin[:3] -= frame_shift[ee_link]

    model = RobotModel.from_joints(
        rname, order, jrows, spheres=sph_rows,
        ee_link=ee_link, ee_origin=ee_origin)

    if active is None and manip is not None and ee_link is not None:
        # default active DOFs = the manipulator's arm chain (OpenRAVE
        # GetArmIndices semantics, the set test_wam7.py:52 activates):
        # the enabled joints on the path effector → <base> (or root),
        # ordered base→tip
        child_to_joint = {j["child"]: j for j in jrows}
        chain = []
        b = ee_link
        while b in child_to_joint and b != manip_base:
            j = child_to_joint[b]
            if j["type"] != "fixed":
                chain.append(j["name"])
            b = j["parent"]
        active = list(reversed(chain))

    if active is not None:
        model = model.set_active(active)
    return model
