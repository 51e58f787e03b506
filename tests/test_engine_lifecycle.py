"""Engine-cache lifecycle: eviction, LRU bound, and actual HBM release.

The reference frees SDF grids and run state eagerly (removefield
orcdchomp_mod.cpp:799-847, run_destroy 3039-3066).  This build's
equivalent obligations: (1) editing the field registry must not strand
engines built against the old registry (each pins a full FieldStack in
device memory), (2) per-hook/per-spec cache entries must stay bounded,
(3) an evicted engine must actually BE freed — which requires the
driver jits to be engine-owned (a class-level @jit(static self) pins
every engine in the global jit cache forever).
"""

import gc
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])


def _module():
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def test_stale_engines_evicted_on_field_change():
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=7)
    assert len(mod._engine_cache) == 1
    mod.iterate(run=h, n_iter=2)          # exercise the per-engine jits
    eng_ref = weakref.ref(mod.runs[h].engine)
    fields_ref = weakref.ref(mod.runs[h].engine.fields.data)

    # replace the field registry: stale engine must leave the cache
    mod.removefield(kinbody="table")
    assert len(mod._engine_cache) == 0

    # the run still works (it owns its engine reference) ...
    mod.destroy(run=h)
    # ... and once the run is gone, nothing may pin the engine or its
    # FieldStack device buffers (the r4 leak: jit caches keyed on the
    # static engine kept both alive forever)
    gc.collect()
    assert eng_ref() is None, "evicted+destroyed engine still referenced"
    assert fields_ref() is None, "FieldStack device buffer still alive"


def test_engine_cache_lru_bound():
    mod = _module()
    cap = mod.ENGINE_CACHE_MAX
    # distinct cache keys at the current fields_version (as created by
    # e.g. distinct per-call start_cost hooks, the ADVICE r4 leak)
    for i in range(cap + 4):
        mod._engine_cache[("spec%d" % i, 0, mod._fields_version,
                           None, i)] = object()
        mod._evict_engines()
    assert len(mod._engine_cache) == cap
    # oldest entries were the ones dropped
    assert ("spec0", 0, mod._fields_version, None, 0) \
        not in mod._engine_cache
    assert ("spec%d" % (cap + 3), 0, mod._fields_version, None,
            cap + 3) in mod._engine_cache


def test_engine_cache_hit_refreshes_recency():
    mod = _module()
    h1 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    obs_factor=500.0, n_points=7)
    key1 = next(iter(mod._engine_cache))
    # a second identical create must hit the cache (same engine object)
    h2 = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    obs_factor=500.0, n_points=7)
    assert mod.runs[h1].engine is mod.runs[h2].engine
    assert len(mod._engine_cache) == 1
    assert next(iter(mod._engine_cache)) == key1


def test_clear_engine_cache():
    mod = _module()
    mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
               obs_factor=500.0, n_points=7)
    assert mod._engine_cache
    mod.clear_engine_cache()
    assert not mod._engine_cache


def test_iterate_masked_chunk1_valid0_passthrough():
    """The chunk=1 bucket must honor the 'first valid applied' contract
    even at valid=0 (ADVICE r4): a pure pass-through, not one step."""
    mod = _module()
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=7)
    run = mod.runs[h]
    eng = run.engine
    before = np.asarray(run.problem.traj).copy()
    prob, _ = eng.iterate_masked(run.problem, 0, 1)
    np.testing.assert_array_equal(np.asarray(prob.traj), before)
    prob, _ = eng.iterate_masked(run.problem, 1, 1)
    assert np.abs(np.asarray(prob.traj) - before).max() > 0.0
