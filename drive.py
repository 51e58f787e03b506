"""Canonical end-to-end drive of the interactive path: python drive.py."""
import time

import numpy as np

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

t0 = time.time()
mod = oc.CHOMPModule()
mod.add_kinbody(KinBody('table', oc.Scene.build(
    boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
r = Robot('wam', oc.wam7(), q_active=np.array([2.5, -1.8, 0, 2.0, 0, 0.2, 0]))
mod.add_robot(r)
r.enabled = False
mod.computedistancefield(kinbody='table', cube_extent=0.04)
r.enabled = True
print(f"[{time.time()-t0:.1f}s] field built", flush=True)
traj = mod.runchomp(robot='wam', n_iter=100, lambda_=100.0,
                    obs_factor=500.0, n_points=101,
                    adofgoal=[0.4, 0.6, 0.1, 1.3, 0, -0.5, 0])
print(f"[{time.time()-t0:.1f}s] runchomp done; "
      f"traj points={traj.positions.shape} in_collision={traj.in_collision}",
      flush=True)
h = mod.create(robot='wam', adofgoal=[0.4, 0.6, 0.1, 1.3, 0, -0.5, 0],
               n_points=101, lambda_=100.0, obs_factor=500.0)
cost = [0.0]
mod.iterate(run=h, n_iter=100, cost=cost)
print(f"[{time.time()-t0:.1f}s] final cost {cost[0]:.3f} (expect ~26.5)",
      flush=True)
t1 = time.time()
mod.iterate(run=h, n_iter=100)
print(f"warm iterate(100): {time.time()-t1:.2f}s", flush=True)
mod.destroy(run=h)
print("DRIVE OK", flush=True)
