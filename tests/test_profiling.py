"""Phase-taxonomy profiling (the reference's DEBUG_TIMING breakdown,
chomp.h:95-100 / orcdchomp_mod.cpp:2835-2847, carried as named_scope
metadata into the compiled step and its profiler traces)."""

import jax
import numpy as np

from or_cdchomp_jax.utils.profiling import PhaseTimers, phase


def test_step_carries_named_scopes():
    """The compiled step's HLO carries the phase scopes in op metadata,
    which is what attributes device time in a profiler trace."""
    import jax.numpy as jnp

    import or_cdchomp_jax as oc
    from or_cdchomp_jax.api import KinBody, Robot

    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    h = mod.create(robot="wam", adofgoal=np.zeros(7) + 0.3, n_points=8)
    rn = mod.runs[h]
    hlo = jax.jit(rn.engine.step).lower(rn.problem).compile().as_text()
    for ph in ("callbacks", "callback_pre", "fk", "pre_velsaccs",
               "obstacle", "selfcol", "jtmap", "smoothgrad", "limits"):
        assert f"{ph}/" in hlo, f"phase scope {ph} missing from compiled step"
    mod.destroy(run=h)


def test_phase_timers_report():
    t = PhaseTimers()
    with t.tic("fk"):
        pass
    with t.tic("custom"):
        pass
    out = t.report()
    assert "ticks_fk" in out and "ticks_custom" in out


def test_phase_context_manager():
    with phase("fk"):
        x = jax.numpy.ones(3) + 1
    assert float(x[0]) == 2.0
