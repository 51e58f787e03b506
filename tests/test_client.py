"""Client serializers → transport parser round trip (the L6↔L4 loop).

The reference's python bindings build shell-quoted command strings
(orcdchomp.py) that mod::create et al. parse back; here the client
module and transport.send_command must agree the same way.
"""

import json

import numpy as np

import or_cdchomp_jax as oc
from or_cdchomp_jax import client
from or_cdchomp_jax.api import KinBody, Robot


def _module():
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    robot = Robot("wam", oc.wam7(),
                  q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    robot.enabled = True
    return mod


def test_bound_client_full_cycle():
    mod = client.SendCommandModule(_module())
    client.bind(mod)

    h = mod.create(robot="wam", adofgoal=[0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0],
                   lambda_=100.0, obs_factor=500.0, n_points=11, seed=3,
                   use_momentum=True, epsilon=0.1)
    assert isinstance(h, str) and h
    cost = [None]
    mod.iterate(run=h, n_iter=5, cost=cost)
    assert cost[0] is not None and np.isfinite(cost[0])
    traj = json.loads(mod.gettraj(run=h, no_collision_exception=True))
    assert np.asarray(traj["positions"]).shape[1] == 7
    mod.destroy(run=h)


def test_runchomp_wrapper_and_quoting():
    mod = client.SendCommandModule(_module())
    traj = client.runchomp(
        mod, robot="wam", adofgoal=[0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0],
        lambda_=100.0, n_points=11, n_iter=3, no_collision_exception=True,
        dat_filename="/tmp/it's a file.dat")  # quote-escaping exercised
    data = json.loads(traj)
    assert len(data["times"]) == 11
    with open("/tmp/it's a file.dat") as f:
        assert len(f.readlines()) == 3


def test_getname_objects_and_flags():
    inner = _module()
    mod = client.SendCommandModule(inner)

    class Named:
        def GetName(self):
            return "wam"

    h = client.create(mod, robot=Named(), adofgoal=[0.6, 0.7, 0.1, 1.4,
                                                    0.0, -0.3, 0.0],
                      n_points=11, use_hmc=True, hmc_resample_lambda=0.05,
                      seed=1)
    rn = inner.runs[h]
    assert rn.engine.spec.use_hmc
    client.destroy(mod, run=h)


def test_start_cost_rejected_on_wire():
    mod = client.SendCommandModule(_module())
    try:
        client.create(mod, robot="wam", adofgoal=[0] * 7, n_points=11,
                      start_cost="0xdeadbeef")
        raise AssertionError("start_cost over the wire should raise")
    except ValueError as e:
        assert "in-process" in str(e)
