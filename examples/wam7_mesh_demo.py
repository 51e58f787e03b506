"""WAM7 demo with TRIANGLE-MESH obstacles — the reference demo's true
scene shape.

The reference's flagship scenario loads trimesh environment geometry
(`rolly-table.iv` + `mug3.iv`, scripts/test_wam7.py:22-28) and
voxelizes it by probe-cube collision checks
(orcdchomp_mod.cpp:495-525).  This demo reproduces that scene CLASS:
the table (top + pedestal) and the mug are closed triangle meshes fed
through the mesh voxelizer (13-axis triangle-cube SAT; interiors
closed by the flood-fill pass), then solved and collision-re-checked
against the exact winding-number signed mesh distance.

Run:  python examples/wam7_mesh_demo.py  [--n-iter 100]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=101)
    args = ap.parse_args()

    import jax
    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot
    from or_cdchomp_jax.ops.voxelize import box_trimesh, cylinder_trimesh

    print(f"devices: {jax.devices()}")

    # the verified-feasible config-1 scene, as closed triangle meshes
    top_v, top_f = box_trimesh((0.25, 0.4, 0.02))
    leg_v, leg_f = box_trimesh((0.08, 0.08, 0.25))
    mug_v, mug_f = cylinder_trimesh(0.04, 0.06, n=24)
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), top_v, top_f),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), leg_v, leg_f)])))
    mod.add_kinbody(KinBody("mug", oc.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mug_v, mug_f)])))
    robot = Robot("wam", oc.wam7(),
                  q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(robot)

    t0 = time.time()
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    print(f"[{time.time()-t0:.1f}s] mesh SDF built "
          f"({int(np.prod(mod.sdfs[0].grid.sizes))} cells, "
          f"{mod.sdfs[0].grid.sizes})")

    goal = [0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0]
    traj = mod.runchomp(robot="wam", n_iter=args.n_iter, lambda_=100.0,
                        obs_factor=500.0, n_points=args.n_points,
                        adofgoal=goal, no_collision_exception=True)
    print(f"[{time.time()-t0:.1f}s] solved {args.n_iter} iterations, "
          f"{traj.positions.shape[0]} points, "
          f"in_collision={traj.in_collision}")
    assert not traj.in_collision, "mesh-scene solve ended in collision"
    print("MESH DEMO OK")


if __name__ == "__main__":
    main()
