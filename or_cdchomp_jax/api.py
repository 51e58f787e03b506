"""User-facing module API mirroring the reference command surface.

The reference exposes nine string commands on an OpenRAVE module
(orcdchomp_mod.h:58-66) plus python kwarg wrappers
(pythonsrc/orcdchomp/orcdchomp.py).  ``CHOMPModule`` provides the same
operations with the same names, kwargs and defaults — against an
analytic world model instead of an OpenRAVE environment:

 - viewspheres            (orcdchomp_mod.cpp:175-289)   → sphere data
 - computedistancefield   (orcdchomp_mod.cpp:297-589)
 - addfield_fromobsarray  (orcdchomp_mod.cpp:592-722)
 - viewfields             (orcdchomp_mod.cpp:724-797)   → cell data
 - removefield            (orcdchomp_mod.cpp:799-847)
 - create / iterate / gettraj / destroy
                          (orcdchomp_mod.cpp:1800-3066)
 - runchomp               (orcdchomp.py:204-219)

Run handles are opaque strings into a registry (replacing the %p
pointer round-trip, orcdchomp_mod.cpp:2669-2674); multiple concurrent
runs are supported (README.md:86-88).  The massively-batched path
(thousands of problems at once) lives in parallel/batch.py and shares
the same ChompEngine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.chomp import metric as metric_mod
from or_cdchomp_jax.chomp.constraints import TSRConstraintSet
from or_cdchomp_jax.chomp.cost import FieldStack
from or_cdchomp_jax.chomp.problem import ChompProblem, ChompSpec, HmcState
from or_cdchomp_jax.chomp.solver import ChompEngine
from or_cdchomp_jax.models.robot import CompiledFK, RobotModel
from or_cdchomp_jax.ops.edt import signed_edt
from or_cdchomp_jax.ops.flood import exterior_free_mask
from or_cdchomp_jax.ops.grid import Grid3D, pad_stack_grids
from or_cdchomp_jax.ops.voxelize import Scene, scene_distance, voxelize_scene
from or_cdchomp_jax.tsr import TSR
from or_cdchomp_jax.utils import np_pose


@dataclasses.dataclass
class KinBody:
    """A rigid obstacle body: analytic primitive set + world pose."""

    name: str
    scene: Scene
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np_pose.POSE_ID.copy())
    enabled: bool = True
    grabbed_by: Optional[str] = None   # robot currently grabbing this body

    def aabb_at_origin(self, padding=0.0):
        """Conservative AABB of the scene primitives with the body at
        the origin (KinBodyComputeEnabledAABB parity,
        orcdchomp_mod.cpp:376-393)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        sc = self.scene
        bp = np.asarray(sc.box_pose)
        bh = np.asarray(sc.box_half)
        for i in range(bp.shape[0]):
            # rotated box AABB: |R|·half
            from or_cdchomp_jax.tsr import quat_to_R_np
            R = quat_to_R_np(bp[i, 3:])
            ext = np.abs(R) @ bh[i]
            lo = np.minimum(lo, bp[i, :3] - ext)
            hi = np.maximum(hi, bp[i, :3] + ext)
        scenter = np.asarray(sc.sphere_center)
        sradius = np.asarray(sc.sphere_radius)
        for i in range(scenter.shape[0]):
            lo = np.minimum(lo, scenter[i] - sradius[i])
            hi = np.maximum(hi, scenter[i] + sradius[i])
        cp = np.asarray(sc.cyl_pose)
        cr = np.asarray(sc.cyl_radius)
        ch = np.asarray(sc.cyl_half)
        for i in range(cp.shape[0]):
            ext = np.sqrt(cr[i] ** 2 + ch[i] ** 2)  # conservative
            lo = np.minimum(lo, cp[i, :3] - ext)
            hi = np.maximum(hi, cp[i, :3] + ext)
        tv = np.asarray(sc.tri_verts)
        if tv.shape[0]:
            pts = tv.reshape(-1, 3)
            lo = np.minimum(lo, pts.min(axis=0))
            hi = np.maximum(hi, pts.max(axis=0))
        if not np.all(np.isfinite(lo)):
            lo = np.zeros(3)
            hi = np.zeros(3)
        return lo - padding, hi + padding


@dataclasses.dataclass
class Robot:
    """A robot body: kinematic model + current configuration."""

    name: str
    model: RobotModel                 # with active DOFs already selected
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np_pose.POSE_ID.copy())
    q_active: np.ndarray = None
    enabled: bool = True
    grabbed: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.q_active is None:
            self.q_active = np.zeros(self.model.n_dof)
        self.q_active = np.asarray(self.q_active, dtype=np.float64)
        # reference configuration for self-collision-check exclusions:
        # captured at construction (and re-captured at grab/release),
        # never at whatever config the first collision check happens
        # to run at — mirroring OpenRAVE's load-time adjacency
        self._exclude_ref = (self.q_active.copy(), np.asarray(self.pose,
                                                              np.float64).copy())
        self._check_exclude = None

    def GetName(self):  # OpenRAVE-style accessor used by callers
        return self.name

    def _fk(self) -> CompiledFK:
        if not hasattr(self, "_fk_cache"):
            self._fk_cache = CompiledFK(self.model)
        return self._fk_cache

    def _invalidate_fk(self):
        if hasattr(self, "_fk_cache"):
            del self._fk_cache

    def _link_world_pose(self, link: str) -> np.ndarray:
        link_idx = self.model.link_names.index(link)
        fk = self._fk()
        lp, _ = fk.link_poses(
            jnp.asarray(self.q_active, dtype=fk.dtype),
            base_pose=jnp.asarray(self.pose, dtype=fk.dtype))
        return np.asarray(lp)[link_idx].astype(np.float64)

    def _sphere_owners(self):
        """Per-sphere owner tags aligned with model.sphere_radius:
        None for the robot's own spheres, the grabbed body's name for
        spheres added by :meth:`grab`.  Kept as an explicit array so
        releasing one body never shifts another body's spheres."""
        if not hasattr(self, "_owner_tags"):
            self._owner_tags = [None] * len(self.model.sphere_radius)
        return self._owner_tags

    def grab(self, body: "KinBody", link: str):
        """Attach ``body`` to ``link``: its collision spheres re-root to
        the grabbing link and move with the robot from now on
        (GetGrabbed/IsGrabbing handling, orcdchomp_mod.cpp:2200-2208).

        The body's Scene sphere primitives become robot spheres in the
        link frame (boxes/cylinders are approximated by their bounding
        spheres — the reference requires sphere models on grabbed
        bodies the same way, orcdchomp_kdata parity).
        """
        if body.name in self.grabbed:
            raise RuntimeError(f"{body.name} is already grabbed")
        owners = self._sphere_owners()
        link_world = self._link_world_pose(link)
        into_link = np_pose.compose(np_pose.invert(link_world), body.pose)

        centers, radii = body.scene.bounding_spheres()
        local = np.stack([np_pose.apply(into_link, c) for c in centers]) \
            if len(radii) else np.zeros((0, 3))
        self.model = self.model.with_spheres(
            [(link, local[i], float(radii[i])) for i in range(len(radii))])
        self._owner_tags = owners + [body.name] * len(radii)
        self.grabbed[body.name] = (link, into_link)
        body.grabbed_by = self.name
        self._invalidate_fk()
        self._reset_exclude_ref()

    def grabbed_body_pose(self, body_name: str) -> np.ndarray:
        """Current world pose of a grabbed body (it rides the grabbing
        link, as OpenRAVE updates grabbed-body transforms with the
        robot)."""
        link, into_link = self.grabbed[body_name]
        return np_pose.compose(self._link_world_pose(link), into_link)

    def release(self, body: "KinBody"):
        """Detach a grabbed body: remove exactly *its* spheres (found by
        owner tag, robust to multiple simultaneous grabs) and leave the
        body where the grabbing link carried it (OpenRAVE Release
        semantics: the body keeps its current world transform)."""
        body.pose = self.grabbed_body_pose(body.name)
        self.grabbed.pop(body.name)
        owners = self._sphere_owners()
        keep = [i for i, o in enumerate(owners) if o != body.name]
        self.model = self.model.select_spheres(np.asarray(keep))
        self._owner_tags = [owners[i] for i in keep]
        body.grabbed_by = None
        self._invalidate_fk()
        self._reset_exclude_ref()

    def check_exclude_mask(self):
        """(S, S) bool: sphere pairs the hard self-collision *check*
        ignores — adjacent links plus pairs already overlapping at the
        robot's *reference* configuration (OpenRAVE marks initially
        colliding link pairs as adjacent, so its CheckSelfCollision
        never reports them; e.g. the WAM forearm/wrist spheres overlap
        by ~1 cm at zero).  The reference configuration is captured at
        construction and re-captured when the sphere set changes
        (grab/release) — never at whatever config the first collision
        check runs at, so a robot momentarily sitting in a colliding
        config cannot whitelist genuinely-colliding pairs."""
        if self._check_exclude is not None:
            return self._check_exclude
        adj = self.model.sphere_adjacent_link()
        q_ref, pose_ref = self._exclude_ref
        fk = self._fk()
        x = np.asarray(fk.sphere_positions_jit(
            jnp.asarray(q_ref, dtype=fk.dtype),
            jnp.asarray(pose_ref, dtype=fk.dtype)))
        rad = np.asarray(self.model.sphere_radius[fk.sphere_subset])
        dist = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
        overlap = dist < (rad[:, None] + rad[None, :])
        self._check_exclude = adj | overlap
        return self._check_exclude

    def _reset_exclude_ref(self):
        """Re-capture the exclusion reference config (sphere set changed)."""
        self._exclude_ref = (self.q_active.copy(),
                             np.asarray(self.pose, np.float64).copy())
        self._check_exclude = None

    def sphere_world(self, fk: Optional[CompiledFK] = None):
        """World (pos, radius) of all spheres at the current config."""
        fk = fk or self._fk()
        x = np.asarray(fk.sphere_positions_jit(
            jnp.asarray(self.q_active, dtype=fk.dtype),
            jnp.asarray(self.pose, dtype=fk.dtype)))
        return x, np.asarray(self.model.sphere_radius[fk.sphere_subset])

    def aabb_at_origin(self, padding=0.0):
        """AABB of the sphere model with the base at the origin."""
        fk = self._fk()
        x = np.asarray(fk.sphere_positions_jit(
            jnp.asarray(self.q_active, dtype=fk.dtype),
            jnp.asarray(np_pose.POSE_ID, dtype=fk.dtype)))
        r = np.asarray(self.model.sphere_radius)[:, None]
        return (x - r).min(axis=0) - padding, (x + r).max(axis=0) + padding


@dataclasses.dataclass
class SdfEntry:
    """Registry entry (struct sdf, orcdchomp_mod.h:36-40)."""

    kinbody_name: str
    grid: Grid3D
    pose: np.ndarray   # (7,) grid frame in kinbody frame


@dataclasses.dataclass
class Trajectory:
    """Retimed output trajectory (gettraj result)."""

    times: np.ndarray          # (n_points,)
    positions: np.ndarray      # (n_points, n_adof)
    base_poses: Optional[np.ndarray] = None  # (n_points, 7) if floating
    # affine_velocities group of the merged reference trajectory
    # (orcdchomp_mod.cpp:2940-2948): Δpose/Δt per waypoint, zeros at 0
    base_velocities: Optional[np.ndarray] = None  # (n_points, 7)
    in_collision: bool = False

    @property
    def duration(self):
        return float(self.times[-1])

    def sample(self, t):
        """Linear interpolation at time t (retimer is linear)."""
        t = np.clip(t, 0.0, self.duration)
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        i = min(max(i, 0), len(self.times) - 2)
        dt = self.times[i + 1] - self.times[i]
        a = 0.0 if dt <= 0 else (t - self.times[i]) / dt
        q = (1 - a) * self.positions[i] + a * self.positions[i + 1]
        if self.base_poses is None:
            return q, None
        bp = (1 - a) * self.base_poses[i] + a * self.base_poses[i + 1]
        bp = np_pose.normalize(bp)
        return q, bp


@dataclasses.dataclass
class Run:
    """One CHOMP run (struct run, orcdchomp_mod.cpp:886-966)."""

    engine: ChompEngine
    problem: ChompProblem
    spec: ChompSpec
    robot: Robot
    fk: CompiledFK
    n_points: int
    iteration: int = 0
    dat_filename: Optional[str] = None
    no_report_cost: bool = False
    dat_rows: list = dataclasses.field(default_factory=list)
    start_time: float = dataclasses.field(default_factory=time.time)


import functools


@functools.partial(jax.jit, static_argnames=("sizes", "cube_extent"))
def _occupancy_jit(scenes, inv_poses, pose_world_gsdf, lengths, *,
                   sizes, cube_extent):
    """Voxelize + flood-fill as one compiled graph."""
    from or_cdchomp_jax.ops.quat import pose_apply

    grid = Grid3D.create(sizes, lengths)
    centers_w = pose_apply(pose_world_gsdf, grid.all_centers())
    occ = jnp.zeros(sizes, dtype=bool)
    for sc, inv in zip(scenes, inv_poses):
        centers_local = pose_apply(inv, centers_w)
        occ = occ | voxelize_scene(sc, centers_local, cube_extent)
    return exterior_free_mask(occ)  # enclosed pockets → obstacle


@functools.partial(jax.jit, static_argnames=("sizes", "cube_extent"))
def _sdf_build_jit(scenes, inv_poses, pose_world_gsdf, lengths, *,
                   sizes, cube_extent):
    """Whole SDF pipeline — voxelize → flood-fill → signed EDT — as one
    compiled graph (one compilation per grid/scene shape instead of
    thousands of eager op dispatches)."""
    occ = _occupancy_jit(scenes, inv_poses, pose_world_gsdf, lengths,
                         sizes=sizes, cube_extent=cube_extent)
    return signed_edt(occ, lengths)


# above this cell count the O(n²)-per-line device EDT loses to the
# exact O(n)-per-line native host EDT (or_cdchomp_jax/native)
_NATIVE_EDT_CELLS = 192 ** 3


@jax.jit
def _traj_collision_jit(scenes, inv_poses, x, rad, same_link):
    """Sampled collision test: per-body any-hit flags + self-collision.
    x: (T, S, 3) sphere centers; rad: (S,)."""
    from or_cdchomp_jax.ops.quat import pose_apply

    hits = []
    for sc, inv in zip(scenes, inv_poses):
        d = scene_distance(sc, pose_apply(inv, x))
        hits.append(jnp.any(d < rad))
    env_hits = jnp.stack(hits) if hits else jnp.zeros((0,), bool)
    dist = jnp.linalg.norm(x[:, :, None, :] - x[:, None, :, :], axis=-1)
    rsum = rad[:, None] + rad[None, :]
    self_hit = jnp.any((dist < rsum) & ~same_link)
    return env_hits, self_hit


@jax.jit
def _traj_collision_batch_jit(scenes, inv_poses, x, rad, same_link):
    """Batched sampled collision test (gettraj_batch): per-problem
    per-body any-hit flags + self-collision.
    x: (B, T, S, 3) sphere centers; rad: (S,)."""
    from or_cdchomp_jax.ops.quat import pose_apply

    hits = []
    for sc, inv in zip(scenes, inv_poses):
        d = scene_distance(sc, pose_apply(inv, x))
        hits.append(jnp.any(d < rad, axis=(1, 2)))          # (B,)
    env_hits = (jnp.stack(hits)
                if hits else jnp.zeros((0, x.shape[0]), bool))
    dist = jnp.linalg.norm(x[:, :, :, None, :] - x[:, :, None, :, :],
                           axis=-1)
    rsum = rad[:, None] + rad[None, :]
    self_hit = jnp.any((dist < rsum) & ~same_link, axis=(1, 2, 3))
    return env_hits, self_hit


_DEFAULTS = dict(  # orcdchomp_mod.cpp:1840-1875
    n_points=101, lambda_=10.0, epsilon=0.1, epsilon_self=0.04,
    obs_factor=200.0, obs_factor_self=10.0, hmc_resample_lambda=0.02,
    derivative=1,
)


class CHOMPModule:
    """The module: world registry + SDF registry + run registry."""

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype
        self.bodies: Dict[str, KinBody] = {}
        self.robots: Dict[str, Robot] = {}
        self.sdfs: List[SdfEntry] = []
        self.runs: Dict[str, Run] = {}
        self._next_run = 0
        # engine cache: bounded + generation-evicted (see
        # _evict_engines); insertion order doubles as LRU order
        self._engine_cache = {}
        self._fields_version = 0

    # max engines kept alive by the cache (each pins a full HBM
    # FieldStack + its compiled executables); live runs keep their own
    # engine references, so eviction never breaks an existing run
    ENGINE_CACHE_MAX = 16

    def _evict_engines(self):
        """Drop cached engines built against a superseded field
        registry — their FieldStack pins device buffers of SDFs that
        were removed/replaced (the reference frees SDF grids eagerly:
        removefield orcdchomp_mod.cpp:799-847, run_destroy 3039-3066)
        — then LRU-bound what remains so per-hook/per-spec entries
        cannot grow without bound."""
        stale = [k for k in self._engine_cache
                 if k[2] != self._fields_version]
        for k in stale:
            del self._engine_cache[k]
        while len(self._engine_cache) > self.ENGINE_CACHE_MAX:
            del self._engine_cache[next(iter(self._engine_cache))]

    def clear_engine_cache(self):
        """Explicitly drop every cached engine (device memory is freed
        once no live run references it)."""
        self._engine_cache.clear()

    # ----- world management ----------------------------------------------

    def add_kinbody(self, body: KinBody):
        self.bodies[body.name] = body
        return body

    def add_robot(self, robot: Robot):
        self.robots[robot.name] = robot
        return robot

    def _get_body(self, name):
        if name in self.bodies:
            return self.bodies[name]
        if name in self.robots:
            return self.robots[name]
        raise KeyError(f"no kinbody named {name!r}")

    def _resolve_robot(self, robot) -> Robot:
        if isinstance(robot, Robot):
            return robot
        return self.robots[robot]

    # ----- viewspheres ----------------------------------------------------

    def viewspheres(self, robot=None, **_):
        """Return the robot's sphere model in world coordinates as a
        list of (name, center, radius) — the data the reference renders
        as orcdchomp_sphere_%d kinbodies (orcdchomp_mod.cpp:175-289)."""
        r = self._resolve_robot(robot)
        x, rad = r.sphere_world()
        return [(f"orcdchomp_sphere_{i}", x[i], float(rad[i]))
                for i in range(len(rad))]

    # ----- distance fields ------------------------------------------------

    def _body_world_pose(self, b: KinBody) -> np.ndarray:
        """Effective world pose: a grabbed body rides its grabbing link
        (its stored ``pose`` is stale while grabbed)."""
        if b.grabbed_by and b.grabbed_by in self.robots:
            return self.robots[b.grabbed_by].grabbed_body_pose(b.name)
        return b.pose

    def _world_occupancy_scene(self, _name_unused=None):
        """(scenes, poses) of every *enabled* body — the reference's env
        CheckCollision sees everything enabled, *including* the kinbody
        the field is being built around (the named body only anchors the
        grid; test_wam7.py names the *disabled* robot so the field
        covers all obstacles).  Grabbed bodies are ordinary enabled
        kinbodies in OpenRAVE — seen at their *carried* world pose, not
        wherever they were grabbed."""
        scenes, poses = [], []
        for b in self.bodies.values():
            if not b.enabled:
                continue
            scenes.append(b.scene)
            poses.append(self._body_world_pose(b))
        for r in self.robots.values():
            if not r.enabled:
                continue
            x, rad = r.sphere_world()
            scenes.append(Scene.build(
                spheres=[(x[i], float(rad[i])) for i in range(len(rad))]))
            poses.append(np_pose.POSE_ID)  # sphere centers already world
        return scenes, poses

    def computedistancefield(self, kinbody=None, cube_extent=0.02,
                             aabb_padding=0.2, cache_filename=None,
                             require_cache=False, **_):
        """Build + register an SDF around ``kinbody``.

        (orcdchomp_mod.cpp:297-589: AABB at origin + padding, voxelize,
        flood-fill exterior, signed EDT, binary cache, registry keyed
        by kinbody name.)
        """
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        body = self._get_body(name)
        if any(s.kinbody_name == name for s in self.sdfs):
            raise RuntimeError("We already have an sdf for this kinbody!")

        lo, hi = body.aabb_at_origin()
        center = 0.5 * (lo + hi)
        extents = 0.5 * (hi - lo)
        sizes = np.ceil((extents + aabb_padding) / cube_extent).astype(int)
        lengths = sizes * 2.0 * cube_extent
        grid_pose = np_pose.POSE_ID.copy()
        grid_pose[:3] = center - 0.5 * lengths

        # SDF build phase timing (the reference times voxelize/flood/
        # EDT unconditionally, orcdchomp_mod.cpp:459-565); exposed as
        # module.sdf_timers for observability
        from or_cdchomp_jax.utils.profiling import PhaseTimers
        timers = PhaseTimers()
        self.sdf_timers = timers
        grid = None
        if cache_filename:
            # raw-bytes cache with size validation, the reference's
            # cache format (orcdchomp_mod.cpp:416-444)
            from or_cdchomp_jax.native import grid_cache_read
            with timers.tic("cache_read"):
                data = grid_cache_read(cache_filename,
                                       tuple(int(s) for s in sizes),
                                       dtype=np.float32)
            if data is not None:
                grid = Grid3D(data=jnp.asarray(data, dtype=jnp.float32),
                              lengths=jnp.asarray(lengths, jnp.float32))
        if grid is None:
            if require_cache:
                raise RuntimeError(
                    "Field not found from cache, but require_cache flag set!")
            with timers.tic("sdf_build"):
                grid = self._build_sdf_grid(name, body, grid_pose, sizes,
                                            lengths, cube_extent)
            if cache_filename:
                from or_cdchomp_jax.native import grid_cache_write
                with timers.tic("cache_write"):
                    grid_cache_write(cache_filename,
                                     np.asarray(grid.data, dtype=np.float32))

        self.sdfs.append(SdfEntry(kinbody_name=name, grid=grid,
                                  pose=grid_pose))
        self._fields_version += 1
        self._evict_engines()
        return ""

    def _build_sdf_grid(self, name, body, grid_pose, sizes, lengths,
                        cube_extent):
        # world frame via _body_world_pose: consistent with query-time
        # composition (create/viewfields), so a field anchored to a
        # currently-grabbed body samples occupancy at the carried pose
        pose_world_gsdf = np_pose.compose(self._body_world_pose(body),
                                          grid_pose)
        scenes, poses = self._world_occupancy_scene(name)
        inv_poses = tuple(jnp.asarray(np_pose.invert(p), jnp.float32)
                          for p in poses)
        args = (tuple(scenes), inv_poses,
                jnp.asarray(pose_world_gsdf, jnp.float32),
                jnp.asarray(lengths, jnp.float32))
        kw = dict(sizes=tuple(int(s) for s in sizes),
                  cube_extent=float(cube_extent))
        if int(np.prod(sizes)) > _NATIVE_EDT_CELLS:
            # full native host pipeline for huge grids: multithreaded
            # voxelize → exterior flood → exact O(n)-per-line EDT (the
            # in-graph cells×primitives broadcast would blow HBM here)
            from or_cdchomp_jax.native import build_sdf_native
            data = jnp.asarray(build_sdf_native(
                scenes, poses, pose_world_gsdf, kw["sizes"], lengths,
                kw["cube_extent"]), jnp.float32)
        else:
            data = _sdf_build_jit(*args, **kw)
        return Grid3D(data=data, lengths=jnp.asarray(lengths, jnp.float32))

    def addfield_fromobsarray(self, kinbody=None, obsarray=None, sizes=None,
                              lengths=None, pose=None, **_):
        """Register an SDF computed from a raw occupancy array.

        (orcdchomp_mod.cpp:592-722; obsarray nonzero = obstacle.)
        """
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        self._get_body(name)
        if any(s.kinbody_name == name for s in self.sdfs):
            raise RuntimeError("We already have an sdf for this kinbody!")
        obsarray = np.asarray(obsarray)
        if sizes is not None:
            obsarray = obsarray.reshape(tuple(sizes))
        occupied = obsarray != 0
        lengths = np.asarray(lengths, dtype=np.float64)
        pose = (np_pose.normalize(pose) if pose is not None
                else np_pose.POSE_ID.copy())
        data = signed_edt(jnp.asarray(occupied), lengths)
        grid = Grid3D(data=data, lengths=jnp.asarray(lengths, jnp.float32))
        self.sdfs.append(SdfEntry(kinbody_name=name, grid=grid, pose=pose))
        self._fields_version += 1
        self._evict_engines()
        return ""

    def viewfields(self, **_):
        """Per-field occupied (sd ≤ 0) cell centers in world coords —
        the data viewfields renders (orcdchomp_mod.cpp:724-797)."""
        out = {}
        for s in self.sdfs:
            body = self._get_body(s.kinbody_name)
            pw = np_pose.compose(self._body_world_pose(body), s.pose)
            centers = np.asarray(s.grid.all_centers())
            mask = np.asarray(s.grid.data) <= 0.0
            pts = centers[mask]
            from or_cdchomp_jax.ops.quat import pose_apply
            out[s.kinbody_name] = np.asarray(pose_apply(
                jnp.asarray(pw, jnp.float32), jnp.asarray(pts, jnp.float32)))
        return out

    def removefield(self, kinbody=None, **_):
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        for i, s in enumerate(self.sdfs):
            if s.kinbody_name == name:
                del self.sdfs[i]
                self._fields_version += 1
                self._evict_engines()
                return ""
        raise RuntimeError("kinbody not found, or has no sdf attached!")

    # ----- create ---------------------------------------------------------

    def _field_stack(self):
        grids = [s.grid for s in self.sdfs]
        data, sizes, lengths = pad_stack_grids(grids)
        return FieldStack(data=data, sizes=sizes, lengths=lengths)

    def create(self, robot=None, adofgoal=None, basegoal=None,
               floating_base=False, lambda_=None, starttraj=None,
               n_points=None, con_tsr=None, con_tsrs=None, start_tsr=None,
               start_cost=None, everyn_tsr=None, use_momentum=False,
               use_hmc=False, hmc_resample_lambda=None, seed=0,
               epsilon=None, epsilon_self=None, obs_factor=None,
               obs_factor_self=None, no_report_cost=False,
               dat_filename=None, derivative=None, ee_force=None,
               ee_torque_weights=None, **_):
        """Set up a run; returns an opaque run handle string.

        Same validation rules as mod::create
        (orcdchomp_mod.cpp:2090-2101).
        """
        r = self._resolve_robot(robot)
        n_points = n_points or _DEFAULTS["n_points"]
        lambda_ = _DEFAULTS["lambda_"] if lambda_ is None else lambda_
        epsilon = _DEFAULTS["epsilon"] if epsilon is None else epsilon
        epsilon_self = (_DEFAULTS["epsilon_self"] if epsilon_self is None
                        else epsilon_self)
        obs_factor = _DEFAULTS["obs_factor"] if obs_factor is None else obs_factor
        obs_factor_self = (_DEFAULTS["obs_factor_self"]
                           if obs_factor_self is None else obs_factor_self)
        hmc_resample_lambda = (_DEFAULTS["hmc_resample_lambda"]
                               if hmc_resample_lambda is None
                               else hmc_resample_lambda)
        D = _DEFAULTS["derivative"] if derivative is None else derivative

        if adofgoal is None and starttraj is None:
            raise ValueError("Did not pass either adofgoal or starttraj!")
        if adofgoal is not None and starttraj is not None:
            raise ValueError("Cannot pass both adofgoal and starttraj!")
        if floating_base and basegoal is None and starttraj is None:
            raise ValueError("Passed floating_base with no basegoal!")
        if not floating_base and basegoal is not None:
            raise ValueError("Passed basegoal with no floating_base!")
        if not self.sdfs:
            raise ValueError(
                "No signed distance fields have yet been computed!")
        if lambda_ < 0.01:
            raise ValueError("lambda must be >=0.01!")
        if n_points < 3:
            raise ValueError("n_points must be >=3!")
        if floating_base and start_tsr is not None:
            raise ValueError(
                "floating_base and start_tsr together is not yet implemented!")

        n_adof = r.model.n_dof
        n = (7 if floating_base else 0) + n_adof
        if adofgoal is not None and len(adofgoal) != n_adof:
            raise ValueError("size of adofgoal does not match active dofs!")

        # ee_force / ee_torque_weights: parsed and validated exactly as
        # the reference does (orcdchomp_mod.cpp:2036-2078, 2116-2121),
        # but the corresponding cost was never implemented there either
        # (dead feature, comment at orcdchomp_mod.cpp:1323) — kept for
        # argument-surface parity only.
        if ee_force is not None:
            ee_force = np.atleast_1d(np.asarray(ee_force, dtype=np.float64))
            if ee_force.shape == (1,):
                ee_force = np.array([0.0, 0.0, -float(ee_force[0])])
            elif ee_force.shape != (3,):
                raise ValueError("ee_force must be length 1 or 3!")
        if ee_torque_weights is not None:
            ee_torque_weights = np.asarray(ee_torque_weights,
                                           dtype=np.float64)
            if ee_torque_weights.shape != (n_adof,):
                raise ValueError(
                    "size of ee_torque_weights does not match active dofs!")

        m = n_points - 2 + (1 if start_tsr is not None else 0)
        spec = ChompSpec(
            n_points=n_points, n=n, m=m, D=D, floating_base=floating_base,
            use_momentum=bool(use_momentum or use_hmc), use_hmc=bool(use_hmc),
            start_tsr=start_tsr is not None, n_fields=len(self.sdfs),
        )

        # --- trajectory init (orcdchomp_mod.cpp:2371-2464) ---
        if starttraj is not None:
            st = np.asarray(starttraj, dtype=np.float64)
            if st.shape[1] != n:
                raise ValueError(f"starttraj must have width n={n}")
            src_t = np.linspace(0.0, 1.0, st.shape[0])
            dst_t = np.linspace(0.0, 1.0, n_points)
            traj = np.stack(
                [np.interp(dst_t, src_t, st[:, j]) for j in range(n)], axis=1)
            if floating_base:
                for i in range(n_points):
                    traj[i, :7] = np_pose.normalize(traj[i, :7])
        else:
            start = np.concatenate([r.pose, r.q_active]) if floating_base \
                else r.q_active.copy()
            goal = (np.concatenate([np.asarray(basegoal, dtype=np.float64),
                                    np.asarray(adofgoal, dtype=np.float64)])
                    if floating_base else np.asarray(adofgoal, np.float64))
            a = np.linspace(0.0, 1.0, n_points)[:, None]
            traj = (1 - a) * start[None, :] + a * goal[None, :]
            if floating_base:
                for i in range(n_points):
                    traj[i, :7] = np_pose.normalize(traj[i, :7])

        # --- metric (chomp.c:239-428) ---
        # semiseparable fast path for long default-metric trajectories
        # (metric.py: no m×m matrices, O(m·n) solve)
        use_sep = (metric_mod.sep_eligible(D, start_tsr is None)
                   and m >= metric_mod.SEP_MIN_M)
        ops = None if use_sep else metric_mod.build_metric(
            m, spec.dt, D=D, has_init0=start_tsr is None, has_final0=True)
        init0 = None if start_tsr is not None else traj[0]
        final0 = traj[-1]

        # --- joint limits (orcdchomp_mod.cpp:2638-2660) ---
        lo = np.asarray(r.model.dof_limits_lower, dtype=np.float64)
        hi = np.asarray(r.model.dof_limits_upper, dtype=np.float64)
        if floating_base:
            lo = np.concatenate([np.full(7, -np.inf), lo])
            hi = np.concatenate([np.full(7, np.inf), hi])

        # --- rooted SDFs (orcdchomp_mod.cpp:2347-2369) ---
        pw, pg = [], []
        for s in self.sdfs:
            body = self._get_body(s.kinbody_name)
            # world pose via _body_world_pose: a grabbed anchor body
            # carries its field with the grabbing link
            p = np_pose.compose(self._body_world_pose(body), s.pose)
            pw.append(p)
            pg.append(np_pose.invert(p))
        pw = np.asarray(pw).reshape(-1, 7)
        pg = np.asarray(pg).reshape(-1, 7)

        # --- TSR constraints (orcdchomp_mod.cpp:2569-2614) ---
        entries = []
        tsr_T0w_inv, tsr_Twe_inv = [], []

        def add_con(tsr: TSR, point_idx):
            entries.append((point_idx, tsr.enabled_mask()))
            tsr_T0w_inv.append(np_pose.invert(tsr.T0w))
            tsr_Twe_inv.append(np_pose.invert(tsr.Twe))

        if start_tsr is not None:
            add_con(start_tsr, 0)
        if everyn_tsr is not None:
            for i in range(m):
                add_con(everyn_tsr, i)
        all_con_tsrs = list(con_tsrs or [])
        if con_tsr is not None:
            all_con_tsrs.append(con_tsr)
        for ct in all_con_tsrs:
            # ct: (type, TSR) with type 'all'|'start'|'end'
            ctype, tsr = ct
            if ctype == "start":
                add_con(tsr, 0)
            elif ctype == "end":
                add_con(tsr, m - 1)
            elif ctype == "all":
                for i in range(m):
                    add_con(tsr, i)
            else:
                raise ValueError("con_tsr type must be start, end, or all")
        cons = TSRConstraintSet.build(entries)

        # --- engine (cached by static structure) ---
        fk = CompiledFK(r.model, dtype=self.dtype)
        # keyed on id(start_cost), not truthiness: the engine captures
        # the *callable*, so two runs with different hooks must never
        # share one engine (the cached engine keeps the hook alive, so
        # its id cannot be recycled while the entry exists)
        key = (spec, id(r.model), self._fields_version, cons,
               id(start_cost) if start_cost is not None else None)
        engine = self._engine_cache.pop(key, None)
        if engine is None:
            fields = self._field_stack()
            engine = ChompEngine(
                spec, r.model, fields, cons=cons,
                extra_cost=start_cost, dtype=self.dtype, metric_ops=ops,
                metric_mode="sep" if use_sep else "dense")
        # (re-)insert at the back: insertion order is LRU order
        self._engine_cache[key] = engine
        self._evict_engines()

        B, trC, Evels = engine.build_affine(init0, final0, n)

        # inactive sphere world positions (orcdchomp_mod.cpp:2334-2345)
        order = engine._sphere_order
        n_act = engine.n_spheres_active
        if len(order) > n_act:
            x_all, _ = r.sphere_world(fk)
            inactive_pos = np.asarray(x_all)[order[n_act:]]
        else:
            inactive_pos = np.zeros((0, 3))

        dtype = self.dtype
        C = max(cons.n_constraints, 1)
        problem = ChompProblem(
            traj=jnp.asarray(traj, dtype=dtype),
            robot_pose=jnp.asarray(r.pose, dtype=dtype),
            AG=jnp.zeros((m, n), dtype=dtype),
            B=jnp.asarray(B, dtype=dtype),
            Evels=jnp.asarray(Evels, dtype=dtype),
            trC=jnp.asarray(trC, dtype=dtype),
            jlimit_lower=jnp.asarray(lo, dtype=dtype),
            jlimit_upper=jnp.asarray(hi, dtype=dtype),
            epsilon=jnp.asarray(epsilon, dtype=dtype),
            epsilon_self=jnp.asarray(epsilon_self, dtype=dtype),
            obs_factor=jnp.asarray(obs_factor, dtype=dtype),
            obs_factor_self=jnp.asarray(obs_factor_self, dtype=dtype),
            lambda_=jnp.asarray(lambda_, dtype=dtype),
            hmc_resample_lambda=jnp.asarray(hmc_resample_lambda, dtype=dtype),
            pose_world_gsdf=jnp.asarray(pw, dtype=dtype),
            pose_gsdf_world=jnp.asarray(pg, dtype=dtype),
            field_enabled=jnp.ones(len(self.sdfs), dtype=bool),
            inactive_pos=jnp.asarray(inactive_pos, dtype=dtype),
            tsr_T0w_inv=jnp.asarray(
                np.asarray(tsr_T0w_inv).reshape(-1, 7) if tsr_T0w_inv
                else np.zeros((0, 7)), dtype=dtype),
            tsr_Twe_inv=jnp.asarray(
                np.asarray(tsr_Twe_inv).reshape(-1, 7) if tsr_Twe_inv
                else np.zeros((0, 7)), dtype=dtype),
            hmc=HmcState(
                key=jax.random.PRNGKey(seed),
                resample_iter=jnp.int32(0),
                leapfrog_first=jnp.array(True)),
            iteration=jnp.int32(0),
        )

        handle = f"run{self._next_run}"
        self._next_run += 1
        self.runs[handle] = Run(
            engine=engine, problem=problem, spec=spec, robot=r, fk=fk,
            n_points=n_points, dat_filename=dat_filename,
            no_report_cost=bool(no_report_cost))
        return handle

    # ----- iterate --------------------------------------------------------

    def iterate(self, run=None, n_iter=1, max_time=None,
                trajs_fileformstr=None, cost=None, verbose=False, **_):
        """Run n_iter CHOMP iterations (orcdchomp_mod.cpp:2690-2852).

        Returns the final total cost (which the reference writes to the
        output stream).  ``max_time`` is a wall-clock budget checked
        between chunks; ``trajs_fileformstr`` dumps the trajectory
        before each iteration (slow path).
        """
        rn = self.runs[run]
        if n_iter < 0:
            raise ValueError("n_iter must be >=0!")
        t0 = time.time()
        done = 0
        # per-iteration host work (wall-clock budget checks, trajectory
        # snapshots) forces chunk=1; otherwise run full masked chunks.
        # Both buckets reuse one compiled executable per engine
        # (iterate_masked's valid count is a traced scalar, so varying
        # n_iter or max_time never recompiles; the chunk=1 bucket costs
        # exactly one step per applied iteration).
        chunk = 1 if (max_time is not None or trajs_fileformstr) \
            else rn.engine.ITER_CHUNK
        while done < n_iter:
            todo = min(chunk, n_iter - done)
            if trajs_fileformstr:
                np.savetxt(trajs_fileformstr % rn.iteration,
                           np.asarray(rn.problem.traj))
            rn.problem, costs = rn.engine.iterate_masked(
                rn.problem, todo, chunk)
            costs = np.asarray(costs)[:todo]
            # no_report_cost suppresses per-iteration cost *reporting*
            # (documented at README.md:137; the reference fails to parse
            # it — a latent bug we fix rather than replicate).  The .dat
            # file rows are independent of it: the reference's fprintf
            # to fp_dat is unconditional (orcdchomp_mod.cpp:2810-2818),
            # so a dat_filename run always gets its rows.
            if rn.dat_filename or not rn.no_report_cost:
                for k in range(todo):
                    it = rn.iteration + k
                    if verbose and not rn.no_report_cost:
                        print(f"iter:{it:2d} cost_total:{costs[k,0]:f} "
                              f"cost_obs:{costs[k,1]:f} "
                              f"cost_smooth:{costs[k,2]:f}")
                    rn.dat_rows.append(
                        [it, time.time() - t0, costs[k, 0], costs[k, 1],
                         costs[k, 2]])
            done += todo
            rn.iteration += todo
            if max_time is not None and time.time() - t0 > max_time:
                break
        total, c_obs, c_smooth = (float(x) for x in jax.device_get(
            rn.engine.costs_only_jit(rn.problem)))
        if verbose:
            print(f"iter:{rn.iteration:2d} cost_total:{total:f} "
                  f"cost_obs:{c_obs:f} cost_smooth:{c_smooth:f} [FINAL]")
        if rn.dat_filename:
            with open(rn.dat_filename, "w") as f:
                for row in rn.dat_rows:
                    f.write(" ".join(str(v) for v in row) + "\n")
        if cost is not None:
            cost[0] = total
        return total

    # ----- gettraj --------------------------------------------------------

    def gettraj(self, run=None, no_collision_check=False,
                no_collision_exception=False, no_collision_details=False,
                **_):
        """Extract, retime, and validity-check the trajectory
        (orcdchomp_mod.cpp:2854-3011)."""
        rn = self.runs[run]
        spec = rn.spec
        traj = np.asarray(jax.device_get(rn.problem.traj), dtype=np.float64)
        if spec.floating_base:
            base = traj[:, :7]
            q = traj[:, 7:]
        else:
            base, q = None, traj

        # Linear retiming at joint velocity limits — exact parity with
        # RetimeActiveDOFTrajectory(…, 1.0, 1.0, "LinearTrajectoryRetimer")
        # (orcdchomp_mod.cpp:2905-2911): OpenRAVE's linear retimer times
        # each piecewise-linear joint segment at max|Δq_j|/vmax_j; a
        # linear profile has no acceleration degree of freedom, so the
        # fmaxaccelmult=1.0 argument cannot shape it.
        vmax = np.asarray(rn.robot.model.dof_max_vel, dtype=np.float64)
        dq = np.abs(np.diff(q, axis=0))
        seg = (dq / vmax[None, :]).max(axis=1)
        seg = np.maximum(seg, 1e-6)
        times = np.concatenate([[0.0], np.cumsum(seg)])

        base_vel = None
        if base is not None:
            # The reference's affine_transform trajectory explicitly
            # inherits the active-DOF deltatimes ("using the timing from
            # the active dof trajectory above") and carries
            # affine_velocities = Δpose/deltatime per waypoint
            # (orcdchomp_mod.cpp:2914-2956); reproduce both.
            base_vel = np.zeros_like(base)
            base_vel[1:] = (base[1:] - base[:-1]) / seg[:, None]
        out = Trajectory(times=times, positions=q, base_poses=base,
                         base_velocities=base_vel)

        if not no_collision_check:
            collides = self._check_traj_collision(
                rn, out, report=not no_collision_details)
            out.in_collision = collides
            if collides and not no_collision_exception:
                raise RuntimeError("Resulting trajectory is in collision!")
        return out

    def _check_traj_collision(self, rn: Run, traj: Trajectory, report=True):
        """Sampled validity check every ~0.04 rad of config arc length
        (orcdchomp_mod.cpp:2958-3006), using the sphere model against
        analytic scene geometry + sphere-pair self collision."""
        q = traj.positions
        total_dist = float(np.sum(np.linalg.norm(np.diff(q, axis=0), axis=1)))
        if total_dist <= 0:
            return False
        step_time = traj.duration * 0.04 / total_dist
        ts = np.arange(0.0, traj.duration, max(step_time, 1e-9))

        fk = rn.fk
        model = rn.robot.model
        qs, bases = [], []
        for t in ts:
            qi, bi = traj.sample(t)
            qs.append(qi)
            bases.append(bi if bi is not None else rn.robot.pose)
        qs = jnp.asarray(np.asarray(qs), dtype=fk.dtype)
        bp = jnp.asarray(np.asarray(bases), dtype=fk.dtype)
        x = fk.sphere_positions_jit(qs, bp)             # (T, S, 3)
        rad = jnp.asarray(model.sphere_radius, dtype=fk.dtype)

        scenes, invs, names = [], [], []
        for b in self.bodies.values():
            # bodies grabbed by the *checked* robot move with it and are
            # part of its sphere set; bodies held by other robots stay
            # obstacles at their carried pose (OpenRAVE CheckCollision
            # filters only robot↔own-grabbed pairs)
            if not b.enabled or b.grabbed_by == rn.robot.name:
                continue
            scenes.append(b.scene)
            invs.append(jnp.asarray(
                np_pose.invert(self._body_world_pose(b)), dtype=fk.dtype))
            names.append(b.name)
        same = jnp.asarray(rn.robot.check_exclude_mask())
        env_hits, self_hit = _traj_collision_jit(
            tuple(scenes), tuple(invs), x, rad, same)
        collides = False
        for name, hit in zip(names, np.asarray(env_hits)):
            if hit and report:
                print(f"Collision with {name}")
            collides = collides or bool(hit)
        if bool(self_hit):
            if report:
                print("Self collision")
            collides = True
        return collides

    def gettraj_batch(self, run=None, probs=None,
                      no_collision_check=False, device_chunk=2048, **_):
        """Batch-native gettraj: retime + strict sampled collision
        re-check for a whole BatchSolver problem batch in one call.

        Batched extension beyond the reference (which retimes and
        checks one run at a time, orcdchomp_mod.cpp:2854-3011): same
        linear velocity-limit retiming and 0.04-rad sampled validity
        semantics as :meth:`gettraj`, vectorized over the batch with
        the FK and sphere checks on device in ``device_chunk``-problem
        chunks.  ``run`` supplies the robot/scene context the batch was
        built from; ``probs`` is the (B,)-batched ChompProblem.

        Returns ``(trajs, in_collision)``: a list of B
        :class:`Trajectory` (each with ``.in_collision`` set) and the
        (B,) bool array.  Unlike gettraj, no exception is raised on a
        colliding trajectory — batch callers filter instead.

        ``device_chunk``: chunking lets the host-side interpolation of
        chunk k+1 overlap the device FK+check of chunk k, while
        over-large chunks lose the overlap and stress host memory.  The
        default 2048 is not yet measured on the H100.
        """
        rn = self.runs[run]
        spec = rn.spec
        traj = np.asarray(jax.device_get(probs.traj), dtype=np.float64)
        B, P = traj.shape[0], traj.shape[1]
        if spec.floating_base:
            base, q = traj[:, :, :7], traj[:, :, 7:]
        else:
            base, q = None, traj

        # vectorized linear retime (gettraj semantics, per problem)
        vmax = np.asarray(rn.robot.model.dof_max_vel, dtype=np.float64)
        dq = np.abs(np.diff(q, axis=1))                    # (B, P-1, n)
        seg = np.maximum((dq / vmax[None, None, :]).max(axis=2), 1e-6)
        times = np.concatenate(
            [np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
        base_vel = None
        if base is not None:
            base_vel = np.zeros_like(base)
            base_vel[:, 1:] = (base[:, 1:] - base[:, :-1]) / seg[..., None]

        collides = np.zeros(B, dtype=bool)
        if not no_collision_check:
            collides = self._check_traj_collision_batch(
                rn, q, base, times, seg, device_chunk)

        trajs = []
        for b in range(B):
            out = Trajectory(
                times=times[b], positions=q[b],
                base_poses=None if base is None else base[b],
                base_velocities=None if base_vel is None else base_vel[b])
            out.in_collision = bool(collides[b])
            trajs.append(out)
        return trajs, collides

    def _check_traj_collision_batch(self, rn: Run, q, base, times, seg,
                                    device_chunk):
        """(B,) sampled validity flags (same ~0.04 rad arc sampling and
        sphere tests as _check_traj_collision, batched)."""
        B, P, n = q.shape
        fk = rn.fk
        model = rn.robot.model
        dur = times[:, -1]                                  # (B,)
        dist = np.linalg.norm(np.diff(q, axis=1), axis=2).sum(axis=1)
        active = dist > 0
        # inactive (zero-length) problems get step 0 → all samples at
        # t=0; their verdict is masked to False below regardless
        step = np.where(active, dur * 0.04 / np.maximum(dist, 1e-300),
                        0.0)
        n_samp = np.where(active,
                          np.ceil(dur / np.maximum(step, 1e-9)), 1)
        T_s = int(max(1, n_samp.max()))

        scenes, invs = [], []
        for b in self.bodies.values():
            if not b.enabled or b.grabbed_by == rn.robot.name:
                continue
            scenes.append(b.scene)
            invs.append(jnp.asarray(
                np_pose.invert(self._body_world_pose(b)), dtype=fk.dtype))
        rad = jnp.asarray(model.sphere_radius, dtype=fk.dtype)
        same = jnp.asarray(rn.robot.check_exclude_mask())

        collides = np.zeros(B, dtype=bool)
        for lo in range(0, B, device_chunk):
            hi = min(lo + device_chunk, B)
            nb = hi - lo
            # per-problem uniform-in-time samples; indices past the
            # problem's own sample count collapse to t=0 (a sample the
            # per-run path checks anyway) so parity with gettraj's
            # arange(0, duration, step) is exact
            si = np.arange(T_s)[None, :]
            ts = np.where(si < n_samp[lo:hi, None],
                          si * step[lo:hi, None], 0.0)     # (nb, T_s)
            ts = np.minimum(ts, dur[lo:hi, None])
            # batched Trajectory.sample: idx = last waypoint time <= t
            idx = (times[lo:hi, None, :] <= ts[:, :, None]).sum(-1) - 1
            idx = np.clip(idx, 0, P - 2)
            bi = np.arange(nb)[:, None]
            dt = np.take_along_axis(times[lo:hi], idx + 1, 1) \
                - np.take_along_axis(times[lo:hi], idx, 1)
            a = np.where(dt > 0,
                         (ts - np.take_along_axis(times[lo:hi], idx, 1))
                         / np.where(dt > 0, dt, 1.0), 0.0)
            qs = ((1 - a[..., None]) * q[lo:hi][bi, idx]
                  + a[..., None] * q[lo:hi][bi, idx + 1])  # (nb, T_s, n)
            if base is not None:
                bp = ((1 - a[..., None]) * base[lo:hi][bi, idx]
                      + a[..., None] * base[lo:hi][bi, idx + 1])
                # normalize only the quaternion part (np_pose.normalize
                # semantics, vectorized)
                bp = np.concatenate(
                    [bp[..., :3],
                     bp[..., 3:] / np.linalg.norm(bp[..., 3:], axis=-1,
                                                  keepdims=True)], -1)
            else:
                bp = np.broadcast_to(np.asarray(rn.robot.pose),
                                     (nb, T_s, 7))
            x = fk.sphere_positions_jit(
                jnp.asarray(qs.reshape(nb * T_s, n), dtype=fk.dtype),
                jnp.asarray(np.ascontiguousarray(
                    bp.reshape(nb * T_s, 7)), dtype=fk.dtype))
            S = x.shape[-2]
            x = x.reshape(nb, T_s, S, 3)
            env_hits, self_hit = _traj_collision_batch_jit(
                tuple(scenes), tuple(invs), x, rad, same)
            hit = np.asarray(self_hit)
            if env_hits.shape[0]:
                hit = hit | np.asarray(env_hits).any(axis=0)
            collides[lo:hi] = hit & active[lo:hi]
        return collides

    # ----- string transport (orcwrap parity) ------------------------------

    def SendCommand(self, cmd: str, releasegil: bool = False) -> str:
        """Dispatch a shell-quoted command string (the reference's
        SendCommand wire format, orcwrap.cpp:37-69)."""
        from or_cdchomp_jax.transport import send_command
        return send_command(self, cmd)

    # ----- destroy / runchomp --------------------------------------------

    def destroy(self, run=None, **_):
        del self.runs[run]
        return ""

    def runchomp(self, n_iter=None, max_time=None, trajs_fileformstr=None,
                 cost=None, no_collision_check=False,
                 no_collision_exception=False, no_collision_details=False,
                 **kwargs):
        """create + iterate + gettraj + destroy (orcdchomp.py:204-219)."""
        run = self.create(**kwargs)
        try:
            self.iterate(run=run, n_iter=1 if n_iter is None else n_iter,
                         max_time=max_time,
                         trajs_fileformstr=trajs_fileformstr, cost=cost)
            traj = self.gettraj(
                run=run, no_collision_check=no_collision_check,
                no_collision_exception=no_collision_exception,
                no_collision_details=no_collision_details)
        finally:
            self.destroy(run=run)
        return traj
