"""Declarative kinematic trees with batched FK and analytic Jacobians.

This replaces the reference's dependence on OpenRAVE for forward
kinematics and Jacobians (SetActiveDOFValues / CalculateJacobian calls
in the per-iteration hot loop, orcdchomp_mod.cpp:968-1132).  Instead of
an external engine mutating shared robot state, the robot is a static
declarative tree and FK is a pure function, vmappable over
(problems × waypoints) and traced once under jit.

Design:
 - Links in topological order; link 0 is the base.  Each non-base link
   is connected to its parent by one joint: a fixed origin pose in the
   parent frame followed by a revolute/prismatic/fixed motion.
 - "Active DOFs" mirror OpenRAVE's active-DOF mechanism
   (orcdchomp_mod.cpp:2265-2299): non-active joints are *frozen* at
   their current values at problem-creation time and folded into the
   fixed origin poses, so the compiled FK touches only active DOFs.
 - Sphere collision geometry per link (the <orcdchomp><spheres> model,
   orcdchomp_kdata.h:39-45).  A sphere is "active" iff an active DOF
   affects its link (orcdchomp_mod.cpp:2270-2273).
 - Position Jacobians are analytic: one broadcasted
   ancestor-mask × (axis × (x − origin)) expression over all
   spheres × DOFs — no per-joint loop in the compiled graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.ops import quat as qt

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2
_JTYPES = {"fixed": FIXED, "revolute": REVOLUTE, "hinge": REVOLUTE,
           "prismatic": PRISMATIC, "slider": PRISMATIC}


def _pose_compose64(pab, pbc):
    """Pure-numpy float64 pose compose (no jax)."""
    qab = pab[3:]
    qbc = pbc[3:]
    ax, ay, az, aw = qab
    bx, by, bz, bw = qbc
    q = np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])
    pos = _rotate64(qab, pbc[:3]) + pab[:3]
    return np.concatenate([pos, q])


def _rotate64(q, v):
    qx, qy, qz, qw = q
    x, y, z = v
    qx2, qy2, qz2, qw2 = qx * qx, qy * qy, qz * qz, qw * qw
    xy, xz, xw = qx * qy, qx * qz, qx * qw
    yz, yw, zw = qy * qz, qy * qw, qz * qw
    return np.array([
        x * (qx2 - qy2 - qz2 + qw2) + 2 * y * (xy - zw) + 2 * z * (xz + yw),
        2 * x * (xy + zw) + y * (-qx2 + qy2 - qz2 + qw2) + 2 * z * (yz - xw),
        2 * x * (xz - yw) + 2 * y * (yz + xw) + z * (-qx2 - qy2 + qz2 + qw2),
    ])


def _motion_pose64(jtype, axis, value):
    if jtype == REVOLUTE:
        a2 = 0.5 * value
        q = np.concatenate([np.sin(a2) * axis, [np.cos(a2)]])
        return np.concatenate([np.zeros(3), q])
    if jtype == PRISMATIC:
        return np.concatenate([axis * value, [0.0, 0.0, 0.0, 1.0]])
    return np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot description (host-side numpy; hashable by identity).

    ``dof_index[i]`` is the active-DOF column of link i's joint, or -1
    when the joint is fixed/frozen.  Frozen joints carry their value in
    ``q_frozen`` and are folded into ``origin`` by :meth:`set_active`.
    """

    name: str
    link_names: tuple
    joint_names: tuple           # joint into link i ('' for base)
    parent: np.ndarray           # (L,) int, parent[0] = -1
    origin: np.ndarray           # (L, 7) float64
    jtype: np.ndarray            # (L,) int
    axis: np.ndarray             # (L, 3) float64 (unit, in joint frame)
    dof_index: np.ndarray        # (L,) int
    q_frozen: np.ndarray         # (L,) float64
    n_dof: int
    dof_limits_lower: np.ndarray  # (n_dof,)
    dof_limits_upper: np.ndarray
    dof_max_vel: np.ndarray       # (n_dof,) for retiming
    sphere_link: np.ndarray       # (S,) int
    sphere_pos: np.ndarray        # (S, 3)
    sphere_radius: np.ndarray     # (S,)
    ee_link: int = -1             # end-effector link (active manipulator)
    ee_origin: Optional[np.ndarray] = None  # (7,) tool pose in ee link

    # ----- construction ----------------------------------------------------

    @classmethod
    def from_joints(cls, name, links, joints, spheres=(), ee_link=None,
                    ee_origin=None):
        """Build from declarative lists.

        links: sequence of link names (first = base).
        joints: dict-like rows with keys
          name, parent, child, type, origin (7 or None), axis (3),
          limits (lo, hi) or None, max_vel (optional).
        spheres: rows (link_name, pos3, radius).
        """
        link_idx = {n: i for i, n in enumerate(links)}
        L = len(links)
        parent = np.full(L, -1, dtype=np.int64)
        origin = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (L, 1))
        jtype = np.zeros(L, dtype=np.int64)
        axis = np.tile(np.array([0.0, 0.0, 1.0]), (L, 1))
        jnames = [""] * L
        limits = {}
        max_vels = {}
        dof_index = np.full(L, -1, dtype=np.int64)
        ndof = 0
        for j in joints:
            ci = link_idx[j["child"]]
            parent[ci] = link_idx[j["parent"]]
            jnames[ci] = j["name"]
            jtype[ci] = _JTYPES[j.get("type", "revolute")]
            if j.get("origin") is not None:
                origin[ci] = np.asarray(j["origin"], dtype=np.float64)
            if j.get("axis") is not None:
                a = np.asarray(j["axis"], dtype=np.float64)
                axis[ci] = a / np.linalg.norm(a)
            if jtype[ci] != FIXED:
                dof_index[ci] = ndof
                limits[ndof] = j.get("limits") or (-np.inf, np.inf)
                max_vels[ndof] = j.get("max_vel", 1.0)
                ndof += 1
        # verify topological ordering
        for i in range(1, L):
            if parent[i] < 0 or parent[i] >= i:
                raise ValueError(f"links must be topologically ordered; "
                                 f"link {links[i]} has parent index {parent[i]}")
        lo = np.array([limits[d][0] for d in range(ndof)], dtype=np.float64)
        hi = np.array([limits[d][1] for d in range(ndof)], dtype=np.float64)
        mv = np.array([max_vels[d] for d in range(ndof)], dtype=np.float64)
        sl = np.array([link_idx[s[0]] for s in spheres], dtype=np.int64)
        sp = np.array([s[1] for s in spheres], dtype=np.float64).reshape(-1, 3)
        sr = np.array([s[2] for s in spheres], dtype=np.float64)
        return cls(
            name=name, link_names=tuple(links), joint_names=tuple(jnames),
            parent=parent, origin=origin, jtype=jtype, axis=axis,
            dof_index=dof_index, q_frozen=np.zeros(L), n_dof=ndof,
            dof_limits_lower=lo, dof_limits_upper=hi, dof_max_vel=mv,
            sphere_link=sl, sphere_pos=sp, sphere_radius=sr,
            ee_link=link_idx[ee_link] if ee_link is not None else -1,
            ee_origin=(np.asarray(ee_origin, dtype=np.float64)
                       if ee_origin is not None else None),
        )

    @property
    def dof_names(self):
        inv = {}
        for i in range(len(self.link_names)):
            d = self.dof_index[i]
            if d >= 0:
                inv[int(d)] = self.joint_names[i]
        return tuple(inv[d] for d in range(self.n_dof))

    def set_active(self, active: Sequence, q_current=None) -> "RobotModel":
        """Freeze all DOFs except ``active`` (names or indices) at
        ``q_current`` (full config, defaults to zeros), renumbering the
        remaining DOFs.  Mirrors OpenRAVE SetActiveDOFs +
        orcdchomp's frozen-inactive-joint semantics.
        """
        names = self.dof_names
        active_ids = []
        for a in active:
            active_ids.append(names.index(a) if isinstance(a, str) else int(a))
        q_current = (np.zeros(self.n_dof) if q_current is None
                     else np.asarray(q_current, dtype=np.float64))

        L = len(self.link_names)
        new_dof = np.full(L, -1, dtype=np.int64)
        new_frozen = self.q_frozen.copy()
        remap = {old: new for new, old in enumerate(active_ids)}
        for i in range(L):
            d = int(self.dof_index[i])
            if d < 0:
                continue
            if d in remap:
                new_dof[i] = remap[d]
            else:
                new_frozen[i] = q_current[d]
        lo = self.dof_limits_lower[active_ids]
        hi = self.dof_limits_upper[active_ids]
        mv = self.dof_max_vel[active_ids]
        return dataclasses.replace(
            self, dof_index=new_dof, q_frozen=new_frozen,
            n_dof=len(active_ids), dof_limits_lower=lo, dof_limits_upper=hi,
            dof_max_vel=mv,
        )

    def with_spheres(self, rows) -> "RobotModel":
        """Append collision spheres; rows: (link_name, pos3, radius).
        Used for grabbed-body geometry re-rooted to the grabbing link
        (orcdchomp_mod.cpp:2200-2208)."""
        if not rows:
            return self
        link_idx = {n: i for i, n in enumerate(self.link_names)}
        sl = np.concatenate([self.sphere_link,
                             np.array([link_idx[r[0]] for r in rows])])
        sp = np.concatenate([self.sphere_pos,
                             np.asarray([r[1] for r in rows],
                                        dtype=np.float64).reshape(-1, 3)])
        sr = np.concatenate([self.sphere_radius,
                             np.asarray([r[2] for r in rows],
                                        dtype=np.float64)])
        return dataclasses.replace(self, sphere_link=sl, sphere_pos=sp,
                                   sphere_radius=sr)

    def select_spheres(self, idx) -> "RobotModel":
        """Keep only the spheres at ``idx`` (release of a grabbed body)."""
        idx = np.asarray(idx)
        return dataclasses.replace(
            self, sphere_link=self.sphere_link[idx],
            sphere_pos=self.sphere_pos[idx],
            sphere_radius=self.sphere_radius[idx])

    # ----- static analysis -------------------------------------------------

    def folded(self):
        """Fold frozen joints into origin poses; returns
        (origin (L,7) with frozen motion composed in, is_active (L,) bool).
        """
        L = len(self.link_names)
        origin = self.origin.copy()
        active = np.zeros(L, dtype=bool)
        for i in range(L):
            if self.dof_index[i] >= 0:
                active[i] = True
            elif self.jtype[i] != FIXED:
                m = _motion_pose64(int(self.jtype[i]), self.axis[i],
                                   float(self.q_frozen[i]))
                origin[i] = _pose_compose64(origin[i], m)
        return origin, active

    def ancestor_dof_mask(self):
        """(L, n_dof) bool: does active DOF d affect link i?
        (the DoesAffect test, orcdchomp_mod.cpp:2270-2272)"""
        L = len(self.link_names)
        mask = np.zeros((L, self.n_dof), dtype=bool)
        for i in range(L):
            j = i
            while j > 0:
                d = int(self.dof_index[j])
                if d >= 0:
                    mask[i, d] = True
                j = int(self.parent[j])
        return mask

    def sphere_active_mask(self):
        """(S,) bool: sphere affected by an active DOF."""
        return self.ancestor_dof_mask()[self.sphere_link].any(axis=1)

    def sphere_same_link(self):
        """(S, S) bool: spheres on the same link (self-collision skip,
        orcdchomp_mod.cpp:1256)."""
        return self.sphere_link[:, None] == self.sphere_link[None, :]

    def sphere_adjacent_link(self):
        """(S, S) bool: same link OR links connected through only fixed
        /frozen joints OR parent-child — the pairs a hard self-collision
        *check* must ignore (OpenRAVE's adjacency filtering; the soft
        epsilon_self cost intentionally keeps parent-child pairs)."""
        L = len(self.link_names)
        # map each link to its nearest "articulated root": walk up
        # through fixed/frozen joints
        art = np.arange(L)
        for i in range(L):
            j = i
            while j > 0 and self.dof_index[j] < 0:
                j = int(self.parent[j])
            art[i] = j
        # parent articulated link of each articulated link
        def art_parent(i):
            j = int(self.parent[i])
            while j > 0 and self.dof_index[j] < 0:
                j = int(self.parent[j])
            return j if i > 0 else -1
        adj = np.zeros((L, L), dtype=bool)
        for i in range(L):
            ai = art[i]
            for j in range(L):
                aj = art[j]
                if ai == aj:
                    adj[i, j] = True
                elif art_parent(ai) == aj or art_parent(aj) == ai:
                    adj[i, j] = True
        return adj[self.sphere_link][:, self.sphere_link]


class FkSoA(NamedTuple):
    """Structure-of-arrays FK outputs (see CompiledFK.fk_soa): component
    tuples, batch axis minor."""

    x: tuple          # vec3 (n_points, S, B) sphere world centers
    anch_pos: tuple   # vec3 (n_points, D, B) joint frames, pre-motion
    anch_q: tuple     # quat (n_points, D, B)
    axis_w: tuple     # vec3 (n_points, D, B) world joint axes
    red_pos: tuple    # vec3 (n_points, n_red, B) reduced link poses
    red_q: tuple      # quat (n_points, n_red, B)


class CompiledFK:
    """Jit-friendly FK closures for a RobotModel with frozen joints
    folded in.  All static structure is baked as Python constants or
    jnp constants at construction; the returned functions are pure in
    (q, base_pose)."""

    def __init__(self, model: RobotModel, dtype=jnp.float32,
                 sphere_subset=None):
        """sphere_subset: optional index array selecting (and ordering)
        the spheres this FK instance computes — the engine uses the
        active-first ordering (orcdchomp_mod.cpp:2265-2299)."""
        self.model = model
        self.dtype = dtype
        origin64, self._link_active = model.folded()
        self._origin = jnp.asarray(origin64, dtype=dtype)
        self._axis = jnp.asarray(model.axis, dtype=dtype)
        self._parent = [int(p) for p in model.parent]
        self._jtype = [int(t) for t in model.jtype]
        self._dof = [int(d) for d in model.dof_index]
        self.n_dof = model.n_dof
        self.n_links = len(model.link_names)
        # per-DOF link index (link whose joint is that DOF)
        self._dof_link = [0] * model.n_dof
        for i, d in enumerate(self._dof):
            if d >= 0:
                self._dof_link[d] = i
        subset = (np.arange(len(model.sphere_link)) if sphere_subset is None
                  else np.asarray(sphere_subset))
        self.sphere_subset = subset
        self._sphere_link = jnp.asarray(model.sphere_link[subset])
        self._sphere_pos = jnp.asarray(model.sphere_pos[subset], dtype=dtype)
        self.sphere_radius = jnp.asarray(
            model.sphere_radius[subset], dtype=dtype)
        # (S, n_dof) DOF-affects-sphere mask
        mask = model.ancestor_dof_mask()[model.sphere_link[subset]]
        self._sphere_dof_mask = jnp.asarray(mask)
        self._sphere_dof_mask_np = np.asarray(mask)
        # suffix structure of the mask (serial chains): when every
        # sphere's affected-dof set is a prefix [0, k_s), sorting
        # spheres by k_s makes each dof's affected-sphere set a suffix
        # of the sorted order — the (S, D)-masked reductions of the Jᵀ
        # map then collapse to one reverse cumsum over S plus D static
        # row picks (apply_sphere_jacT_soa), cutting the jtmap phase's
        # dominant (m, S, D, B) broadcast-reduce work ~D-fold.
        self._jt_suffix = None
        S, D = mask.shape
        if S and D:
            k = mask.sum(axis=1)
            if np.all(mask == (np.arange(D)[None, :] < k[:, None])):
                order = np.argsort(k, kind="stable")
                # start_d = #spheres with k_s <= d  (suffix start row)
                start = np.searchsorted(k[order], np.arange(D),
                                        side="right")
                self._jt_suffix = (order, start)
        self._axis_np = np.asarray(model.axis, dtype=np.float64)
        self._jtype_per_dof_np = np.asarray(
            [self._jtype[self._dof_link[d]] for d in range(model.n_dof)])
        self._jtype_per_dof = jnp.asarray(self._jtype_per_dof_np)
        self._build_reduced_chain(model, origin64, subset)

    # ----- reduced chain ---------------------------------------------------

    def _build_reduced_chain(self, model, origin64, subset):
        """Fold every fixed/frozen joint into per-link constant offsets
        so the compiled FK walks only *active* joints.

        Each link's pose factors as pose(red(l)) ∘ off(l) where red(l)
        is its nearest ancestor (or self) with an active joint and
        off(l) is a constant.  The active chain then needs one constant
        compose + one motion compose per active DOF, and sphere world
        positions come straight from the reduced poses with the sphere
        offsets pre-folded — the whole frozen finger subtree of the WAM
        model (orcdchomp frozen-inactive-joint semantics) costs zero ops
        in the hot path."""
        L = self.n_links
        ID = np.array([0, 0, 0, 0, 0, 0, 1.0])
        red_slot = np.zeros(L, dtype=np.int64)
        off = np.tile(ID, (L, 1))
        chain = []
        next_slot = 1
        for i in range(1, L):
            p = int(model.parent[i])
            d = int(model.dof_index[i])
            if d >= 0:
                K = _pose_compose64(off[p], origin64[i])
                chain.append(dict(
                    dof=d, parent_slot=int(red_slot[p]),
                    jtype=int(model.jtype[i]),
                    axis=np.asarray(model.axis[i], dtype=np.float64),
                    K=K,
                    rot_id=bool(np.allclose(K[3:], ID[3:], atol=1e-14)),
                    pos_zero=bool(np.allclose(K[:3], 0.0, atol=1e-14))))
                red_slot[i] = next_slot
                next_slot += 1
            else:
                off[i] = _pose_compose64(off[p], origin64[i])
                red_slot[i] = red_slot[p]
        self._chain = chain
        self.n_red = next_slot
        self._red_slot = [int(s) for s in red_slot]
        self._off64 = off
        self._off_id = [bool(np.allclose(off[i], ID, atol=1e-14))
                        for i in range(L)]
        self._red_slot_links = jnp.asarray(red_slot)
        self._off_q = jnp.asarray(off[:, 3:], dtype=self.dtype)
        self._off_p = jnp.asarray(off[:, :3], dtype=self.dtype)
        # sphere offsets folded through off(link): world sphere pos is
        # pose_apply(red_pose[slot], folded_pos)
        sl = model.sphere_link[subset]
        folded = np.stack(
            [_rotate64(off[li, 3:], model.sphere_pos[subset][k])
             + off[li, :3] for k, li in enumerate(sl)]) \
            if len(sl) else np.zeros((0, 3))
        self._sphere_red_slot = jnp.asarray(red_slot[sl]) if len(sl) else \
            jnp.zeros((0,), jnp.int32)
        self._sphere_folded_pos = jnp.asarray(folded, dtype=self.dtype)
        self._sphere_red_slot_np = (np.asarray(red_slot[sl]) if len(sl)
                                    else np.zeros((0,), np.int64))
        self._sphere_folded_np = np.asarray(folded, dtype=np.float64)

    def red_poses(self, q, base_pose=None):
        """World poses of the reduced (active-joint) chain.

        q: (..., n_dof).  Returns (red (..., n_red, 7), anchors
        (..., n_dof, 7)) with red[..., 0, :] the base pose and one entry
        per active joint; anchors are the joint frames *before* joint
        motion (world axis/origin of each active DOF)."""
        q = jnp.asarray(q, dtype=self.dtype)
        batch = q.shape[:-1]
        if base_pose is None:
            base_pose = jnp.broadcast_to(qt.pose_identity(self.dtype),
                                         batch + (7,))
        # all revolute motion quats at once: one sin + one cos op
        half = 0.5 * q
        s = jnp.sin(half)
        c = jnp.cos(half)
        red = [base_pose]
        anchors = [None] * self.n_dof
        for e in self._chain:
            parent = red[e["parent_slot"]]
            pq = parent[..., 3:]
            ppos = parent[..., :3]
            aq = pq if e["rot_id"] else qt.quat_compose_const(pq, e["K"][3:])
            apos = ppos if e["pos_zero"] else \
                ppos + qt.quat_rotate_const(pq, e["K"][:3])
            anchor = jnp.concatenate([apos, aq], axis=-1)
            anchors[e["dof"]] = anchor
            d = e["dof"]
            if e["jtype"] == REVOLUTE:
                ax = jnp.asarray(e["axis"], dtype=self.dtype)
                mq = jnp.concatenate(
                    [s[..., d, None] * ax, c[..., d, None]], axis=-1)
                pose = jnp.concatenate(
                    [apos, qt.quat_compose(aq, mq)], axis=-1)
            else:  # prismatic
                step = qt.quat_rotate_const(aq, e["axis"]) * q[..., d, None]
                pose = jnp.concatenate([apos + step, aq], axis=-1)
            red.append(pose)
        red_arr = jnp.stack(red, axis=-2)
        anchors_arr = jnp.stack(anchors, axis=-2) if self.n_dof else \
            jnp.zeros(batch + (0, 7), self.dtype)
        return red_arr, anchors_arr

    def link_pose_red(self, red, link):
        """Pose of one link from reduced poses (constant-offset compose)."""
        rp = red[..., self._red_slot[link], :]
        if self._off_id[link]:
            return rp
        off = self._off64[link]
        pq = rp[..., 3:]
        pos = rp[..., :3] + qt.quat_rotate_const(pq, off[:3])
        return jnp.concatenate([pos, qt.quat_compose_const(pq, off[3:])],
                               axis=-1)

    def _reconstruct_links(self, red):
        """All L link poses from the reduced chain (one batched compose
        against the constant offsets) — API-surface path, not the hot
        per-iteration path."""
        rp = jnp.take(red, self._red_slot_links, axis=-2)   # (..., L, 7)
        pq = rp[..., 3:]
        q = qt.quat_compose(pq, jnp.broadcast_to(self._off_q, pq.shape))
        pos = rp[..., :3] + qt.quat_rotate(pq, self._off_p)
        return jnp.concatenate([pos, q], axis=-1)

    def link_poses(self, q, base_pose=None):
        """World poses of all links.  q: (..., n_dof); returns
        (poses (..., L, 7), anchors (..., n_dof, 7))."""
        red, anchors = self.red_poses(q, base_pose)
        return self._reconstruct_links(red), anchors

    def sphere_positions(self, link_poses):
        """World sphere centers (..., S, 3) from link poses."""
        lp = jnp.take(link_poses, self._sphere_link, axis=-2)
        return qt.pose_apply(lp, self._sphere_pos)

    def sphere_positions_red(self, red):
        """World sphere centers (..., S, 3) straight from reduced poses
        (sphere offsets pre-folded through the frozen subtrees)."""
        rp = jnp.take(red, self._sphere_red_slot, axis=-2)
        return qt.pose_apply(rp, self._sphere_folded_pos)

    def point_jacobian(self, anchors, x, link_mask):
        """Position Jacobian of world point(s) w.r.t. active DOFs.

        anchors: (..., n_dof, 7) joint world frames (pre-motion).
        x: (..., 3) point(s); link_mask: (..., n_dof) bool — whether
        each DOF affects the point's link.
        Returns (..., 3, n_dof).

        Revolute column: axis_w × (x − origin_w); prismatic: axis_w —
        the same quantity OpenRAVE's CalculateJacobian produces.
        """
        axis_local = jnp.stack(
            [self._axis[self._dof_link[d]] for d in range(self.n_dof)]) \
            if self.n_dof else jnp.zeros((0, 3), self.dtype)
        axis_w = qt.quat_rotate(anchors[..., 3:], axis_local)   # (..., D, 3)
        origin_w = anchors[..., :3]                             # (..., D, 3)
        rel = x[..., None, :] - origin_w                        # (..., D, 3)
        rev_col = jnp.cross(axis_w, rel)
        col = jnp.where(
            (self._jtype_per_dof == REVOLUTE)[..., None], rev_col, axis_w)
        col = jnp.where(link_mask[..., None], col, 0.0)
        return jnp.swapaxes(col, -1, -2)                        # (..., 3, D)

    def sphere_jacobians(self, anchors, sphere_x):
        """Jacobians for all spheres: (..., S, 3, n_dof).

        sphere_x: (..., S, 3) world sphere centers.
        """
        mask = self._sphere_dof_mask  # (S, D)
        jac = self.point_jacobian(
            anchors[..., None, :, :], sphere_x, mask)
        return jac

    def apply_sphere_jacT(self, anchors, sphere_x, w):
        """G = Σ_s J(s)ᵀ w_s without materializing any sphere Jacobian.

        anchors: (..., D, 7); sphere_x, w: (..., S, 3).
        Returns (..., D).

        The revolute column is mask_sd · a_d × (x_s − o_d); contracting
        against w_s uses the triple-product identity
        w·(a×(x−o)) = a·(x×w) − a·(o×(Σw)), so the computation touches
        only (..., S, 3) and (..., D, 3) tensors.  The naive einsum
        materializes a (..., S, 3, D) Jacobian — 326 MB per step on the
        batch-256 bench, which makes the Jᵀ map memory-bound.  All
        reductions are broadcast-sum, not dot_general: tiny-K batched
        matmuls would lower to many tiny matrix products.
        """
        axis_local = jnp.stack(
            [self._axis[self._dof_link[d]] for d in range(self.n_dof)]) \
            if self.n_dof else jnp.zeros((0, 3), self.dtype)
        axis_w = qt.quat_rotate(anchors[..., 3:], axis_local)   # (..., D, 3)
        origin_w = anchors[..., :3]                             # (..., D, 3)
        mask = self._sphere_dof_mask.astype(self.dtype)         # (S, D)

        xw = jnp.cross(sphere_x, w)                             # (..., S, 3)
        # Σ_s mask_sd (x_s × w_s) and Σ_s mask_sd w_s → (..., D, 3)
        sum_xw = jnp.sum(xw[..., :, None, :] * mask[:, :, None], axis=-3)
        sum_w = jnp.sum(w[..., :, None, :] * mask[:, :, None], axis=-3)

        g_rev = jnp.sum(axis_w * (sum_xw - jnp.cross(origin_w, sum_w)),
                        axis=-1)
        g_pri = jnp.sum(axis_w * sum_w, axis=-1)
        rev = (self._jtype_per_dof == REVOLUTE)
        return jnp.where(rev, g_rev, g_pri)                     # (..., D)

    # ----- structure-of-arrays (batch-minor) cost path ---------------------
    #
    # Same math as red_poses / sphere_positions_red / apply_sphere_jacT,
    # but with every x/y/z/quat component its own array and the problem
    # batch axis minor (see ops/soa.py for why).  Used by the
    # batch-native step (solver.step_batched) — the per-problem AoS path
    # above remains the parity anchor.


    def fk_soa(self, qT, base_pos, base_q):
        """SoA FK over a batched trajectory.

        qT: (n_points, n_dof, B) joint values, batch minor.
        base_pos / base_q: vec3 / quat component tuples broadcastable to
        (n_points, B) — (B,) for a fixed per-problem base, (n_points, B)
        for a floating per-waypoint base.

        Returns an FkSoA with component tuples (each (n_points, ·, B)):
          x: sphere world centers (·=S); anch_pos / anch_q: joint frames
          pre-motion (·=D); axis_w: world joint axes (·=D);
          red_pos / red_q: reduced-chain link poses (·=n_red).
        """
        from or_cdchomp_jax.ops import soa

        n_points, _, B = qT.shape
        half = 0.5 * qT
        s = jnp.sin(half)
        c = jnp.cos(half)

        red = [(base_pos, base_q)]
        anch = [None] * self.n_dof
        axis_w = [None] * self.n_dof
        for e in self._chain:
            ppos, pq = red[e["parent_slot"]]
            K = e["K"]
            aq = pq if e["rot_id"] else soa.qmul_const(pq, K[3:])
            apos = ppos if e["pos_zero"] else \
                soa.add(ppos, soa.qrot_const(pq, K[:3]))
            d = e["dof"]
            anch[d] = (apos, aq)
            ax = e["axis"]
            axis_w[d] = soa.qrot_const(aq, ax)
            if e["jtype"] == REVOLUTE:
                sd, cd = s[:, d, :], c[:, d, :]
                mq = (sd * float(ax[0]), sd * float(ax[1]),
                      sd * float(ax[2]), cd)
                red.append((apos, soa.qmul(aq, mq)))
            else:  # prismatic
                step = soa.scale(axis_w[d], qT[:, d, :])
                red.append((soa.add(apos, step), aq))

        # sphere world centers from reduced poses (offsets pre-folded)
        full = (n_points, B)
        xs = []
        for k in range(len(self._sphere_red_slot_np)):
            slot = int(self._sphere_red_slot_np[k])
            rpos, rq = red[slot]
            pk = soa.add(soa.qrot_const(rq, self._sphere_folded_np[k]), rpos)
            xs.append(tuple(jnp.broadcast_to(cc, full) for cc in pk))
        dtype = qT.dtype
        if xs:
            x = tuple(jnp.stack([p[ci] for p in xs], axis=1)
                      for ci in range(3))
        else:  # degenerate zero-sphere model (AoS path guards the same)
            x = tuple(jnp.zeros((n_points, 0, B), dtype) for _ in range(3))

        def stack_mid(items, nc):
            if not items:  # n_dof == 0: no joints, empty middle axis
                return tuple(jnp.zeros((n_points, 0, B), dtype)
                             for _ in range(nc))
            return tuple(
                jnp.stack([jnp.broadcast_to(it[ci], full) for it in items],
                          axis=1)
                for ci in range(nc))

        return FkSoA(
            x=x,
            anch_pos=stack_mid([a[0] for a in anch], 3),
            anch_q=stack_mid([a[1] for a in anch], 4),
            axis_w=stack_mid(axis_w, 3),
            red_pos=stack_mid([r[0] for r in red], 3),
            red_q=stack_mid([r[1] for r in red], 4))

    def apply_sphere_jacT_soa(self, anchors_pos, axis_w, x, w):
        """SoA G = Σ_s J(s)ᵀ w_s (same triple-product factoring as
        apply_sphere_jacT).

        anchors_pos / axis_w: vec3 of (m, D, B); x / w: vec3 of
        (m, S, B).  Returns (m, D, B).
        """
        from or_cdchomp_jax.ops import soa

        xw = soa.cross(x, w)

        if self._jt_suffix is not None:
            order, start = self._jt_suffix
            S = len(order)

            def red_sd(comp):  # (m, S, B) → Σ_{s: mask_sd} comp_s
                # suffix-sum trick (see __init__): reorder via static
                # slices instead of a dynamic gather,
                # reverse-cumsum over spheres, pick each dof's suffix
                # start row — O(m·S·B) instead of O(m·S·D·B)
                if np.array_equal(order, np.arange(S)):
                    so = comp
                else:
                    so = jnp.concatenate(
                        [comp[:, i:i + 1, :] for i in order], axis=1)
                suf = jnp.cumsum(so[:, ::-1, :], axis=1)[:, ::-1, :]
                zero = jnp.zeros_like(suf[:, :1, :])
                suf = jnp.concatenate([suf, zero], axis=1)
                return jnp.concatenate(
                    [suf[:, s:s + 1, :] for s in start], axis=1)
        else:
            mask = self._sphere_dof_mask_np.astype(np.float32)  # (S, D)
            maskb = jnp.asarray(mask[None, :, :, None], dtype=w[0].dtype)

            def red_sd(comp):  # (m, S, B) → Σ_s mask · comp → (m, D, B)
                return jnp.sum(comp[:, :, None, :] * maskb, axis=1)

        sum_xw = tuple(red_sd(cc) for cc in xw)
        sum_w = tuple(red_sd(cc) for cc in w)
        oxw = soa.cross(anchors_pos, sum_w)
        g_rev = soa.dot(axis_w, soa.sub(sum_xw, oxw))
        g_pri = soa.dot(axis_w, sum_w)
        if np.all(self._jtype_per_dof_np == REVOLUTE):
            return g_rev
        rev = jnp.asarray(
            (self._jtype_per_dof_np == REVOLUTE)[None, :, None])
        return jnp.where(rev, g_rev, g_pri)

    def fk_spheres(self, q, base_pose=None):
        """One-call convenience: (sphere_x (..., S, 3),
        jac (..., S, 3, n_dof), link_poses (..., L, 7))."""
        red, anchors = self.red_poses(q, base_pose)
        x = self.sphere_positions_red(red)
        jac = self.sphere_jacobians(anchors, x)
        return x, jac, self._reconstruct_links(red)

    def sphere_positions_jit(self, q, base_pose):
        """Jitted (cached) sphere-position FK for host-side callers."""
        if not hasattr(self, "_jit_sphere_pos"):
            def f(q, base_pose):
                red, _ = self.red_poses(q, base_pose)
                return self.sphere_positions_red(red)
            self._jit_sphere_pos = jax.jit(f)
        return self._jit_sphere_pos(q, base_pose)
