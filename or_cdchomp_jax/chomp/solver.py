"""The CHOMP covariant-update solver: one pure step, scanned and batched.

Reimplements cd_chomp_iterate (chomp.c:430-683) plus the HMC momentum
resampling that the reference layers on in mod::iterate
(orcdchomp_mod.cpp:2752-2768) as a single pure function
``step: ChompProblem → (ChompProblem, costs)``:

 1. workspace kinematics + obstacle/self cost gradient  (callbacks)
 2. G += A·T + B                                        (chomp.c:515-522)
 3. AG = A⁻¹·G, or leapfrog momentum accumulation       (chomp.c:524-548)
 4. TSR constraint projection                           (chomp.c:553-600)
 5. T −= (1/λ)·AG                                       (chomp.c:604-605)
 6. joint-limit repair loop (≤1000 rounds)              (chomp.c:608-655)
 7. smoothness cost on the updated trajectory           (chomp.c:660-677)

Device mapping: the m×m A/A⁻¹ products are batched matrix products
shared across the problem batch, at full float32 precision; the repair
loop is a ``lax.while_loop``; HMC uses per-problem jax.random keys
(replacing GSL, orcdchomp_mod.cpp:2302-2304); iteration over n_iter is
``lax.scan``; the problem batch is ``vmap`` + sharding (see parallel/).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from or_cdchomp_jax.chomp import cost as cost_mod
from or_cdchomp_jax.chomp.constraints import (
    TSRConstraintSet, eval_tsr_all, eval_tsr_all_soa, project_constraints)

import os as _os_mod

# TSR-evaluation backend for the batch-native step: "soa" (default,
# batch-minor component form) or "aos" (the vmapped per-problem chain,
# kept A/B-able with benchmarks/ab.py)
_TSR_EVAL = _os_mod.environ.get("CDX_TSR_EVAL", "soa")
# unroll factor for the n_iter solve scan (measurement knob: with a
# large step body per-iteration loop overhead should be noise — this
# knob lets the A/B harness confirm that instead of assuming it)
_ITER_UNROLL = int(_os_mod.environ.get("CDX_ITER_UNROLL", "1"))
from or_cdchomp_jax.chomp.problem import ChompProblem, ChompSpec, HmcState
from or_cdchomp_jax.ops import quat as qt

_MAX_LIMIT_FIXES = 1000  # chomp.c:608


class ChompEngine:
    """Static solver context: spec + robot + fields + metric operators.

    One engine serves every problem that shares its static structure
    (robot, n_points, field registry, constraint layout); problems are
    pytrees batched along a leading axis.
    """

    def __init__(self, spec: ChompSpec, model, fields, A=None, Ainv=None,
                 cons: Optional[TSRConstraintSet] = None,
                 extra_cost: Optional[Callable] = None,
                 dtype=jnp.float32, metric_ops=None, metric_mode="auto"):
        from or_cdchomp_jax.chomp import metric as metric_mod
        from or_cdchomp_jax.models.robot import CompiledFK

        self.spec = spec
        self.fields = fields
        self.dtype = dtype
        self.cons = cons if cons is not None else TSRConstraintSet.build(())
        self.extra_cost = extra_cost
        self.metric_ops = metric_ops

        # metric backend: dense m×m products, or the O(m·n)
        # semiseparable closed form (metric.py) for long trajectories
        sep_ok = metric_mod.sep_eligible(spec.D, not spec.start_tsr)
        if metric_mode == "auto":
            metric_mode = ("sep" if sep_ok and spec.m >= metric_mod.SEP_MIN_M
                           else "dense")
        if metric_mode == "sep" and not sep_ok:
            raise ValueError("semiseparable metric requires D=1 with both "
                             "endpoints fixed (no start_tsr)")
        self.metric_mode = metric_mode
        if metric_mode == "dense":
            if A is None or Ainv is None:
                if metric_ops is None:
                    metric_ops = metric_mod.build_metric(
                        spec.m, spec.dt, D=spec.D,
                        has_init0=not spec.start_tsr)
                    self.metric_ops = metric_ops
                A, Ainv = metric_ops.A, metric_ops.Ainv
            self.A = jnp.asarray(A, dtype=dtype)
            self.Ainv = jnp.asarray(Ainv, dtype=dtype)
        else:
            self.A = None
            self.Ainv = None

        act = (np.ones(len(model.sphere_link), dtype=bool)
               if spec.floating_base else model.sphere_active_mask())
        # active-block-first ordering (orcdchomp_mod.cpp:2265-2299);
        # floating base ⇒ all spheres active (orcdchomp_mod.cpp:2273)
        order = np.concatenate([np.where(act)[0], np.where(~act)[0]])
        self._sphere_order = order
        radii = model.sphere_radius[order]
        n_act = int(act.sum())
        self.radii_act = jnp.asarray(radii[:n_act], dtype=dtype)
        self.radii_all = jnp.asarray(radii, dtype=dtype)
        same = model.sphere_same_link()[order][:, order]
        self.same_link = jnp.asarray(same[:n_act, :])
        self.n_spheres_active = n_act
        self.n_spheres_total = len(order)
        # FK restricted to the active spheres, in active-first order
        self.fk = CompiledFK(model, dtype=dtype, sphere_subset=order[:n_act])

    # -- metric backend ------------------------------------------------------

    def apply_A(self, X):
        """A · X  (m×m gemm, or the tridiagonal stencil in sep mode)."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            return mm.sep_apply_A(X, self.spec.dt)
        return jnp.matmul(self.A, X, precision="highest")

    def solve_A(self, G):
        """A⁻¹ · G  (dense gemm, or two cumsums in sep mode)."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            return mm.sep_solve(G, self.spec.dt)
        return jnp.matmul(self.Ainv, G, precision="highest")

    def ainv_block(self, pts):
        """Ainv[pts, pts] (K, K) for the constraint-projection system."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            return mm.sep_ainv_entries(pts[:, None], pts[None, :],
                                       self.spec.m,
                                       self.spec.dt).astype(self.dtype)
        return self.Ainv[pts[:, None], pts[None, :]]

    def ainv_cols(self, pts):
        """Ainv[:, pts] (m, K) for spreading constraint corrections."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            rows = jnp.arange(self.spec.m)
            return mm.sep_ainv_entries(rows[:, None], pts[None, :],
                                       self.spec.m,
                                       self.spec.dt).astype(self.dtype)
        return self.Ainv[:, pts]

    def build_affine(self, init0, final0, n):
        """(B, trC, Evels) for given endpoint values — closed form in
        sep mode, K/E stacks otherwise (chomp.c:319-330, 348-386)."""
        from or_cdchomp_jax.chomp import metric as mm
        m, dt = self.spec.m, self.spec.dt
        if self.metric_mode == "sep":
            B, trC = mm.sep_B_trC(m, dt, init0, final0, n)
            Ev = mm.sep_Evels(m, dt, init0, final0, n)
            return B, trC, Ev
        ops = self.metric_ops
        if ops is None:
            ops = mm.build_metric(m, dt, D=self.spec.D,
                                  has_init0=not self.spec.start_tsr)
            self.metric_ops = ops
        B, trC = mm.build_B_trC(ops, init0, final0, n)
        Ev = mm.build_Evels(ops, init0, final0, n)
        return B, trC, Ev

    def build_affine_batch(self, inits, finals, n):
        """Vectorized :meth:`build_affine` over a problem batch.

        inits/finals: (P, n) endpoint configurations (inits may be None
        in start_tsr mode).  Returns (B (P, m, n), trC (P,),
        Evels (P, m, n)) as float64 numpy — identical values to calling
        build_affine per row (the metric terms are linear in the
        endpoints; metric.affine_generators), built as two outer
        products instead of P independent K/E stack evaluations.
        """
        from or_cdchomp_jax.chomp import metric as mm
        m, dt = self.spec.m, self.spec.dt
        finals = np.asarray(finals, dtype=np.float64)
        P = finals.shape[0]
        if inits is not None:
            inits = np.asarray(inits, dtype=np.float64)
        if self.metric_mode == "sep":
            s = 1.0 / (dt * dt * (m + 1))
            binit = np.zeros(m)
            binit[0] = -s
            bfinal = np.zeros(m)
            bfinal[m - 1] = -s
            c_ii = c_ff = 0.5 * s
            c_if = 0.0
        else:
            ops = self.metric_ops
            if ops is None:
                ops = mm.build_metric(m, dt, D=self.spec.D,
                                      has_init0=not self.spec.start_tsr)
                self.metric_ops = ops
            binit, bfinal, c_ii, c_if, c_ff = mm.affine_generators(ops)
        B = bfinal[None, :, None] * finals[:, None, :]
        trC = c_ff * np.sum(finals * finals, axis=1)
        Ev = np.zeros((P, m, n))
        if not self.spec.start_tsr:
            Ev[:, 0] = -0.5 / dt * inits
        Ev[:, m - 1] = 0.5 / dt * finals
        if inits is not None and not self.spec.start_tsr:
            B = B + binit[None, :, None] * inits[:, None, :]
            trC = trC + c_ii * np.sum(inits * inits, axis=1) \
                + c_if * np.sum(inits * finals, axis=1)
        return B, trC, Ev

    # -- trajectory row bookkeeping ----------------------------------------

    @property
    def mov_lo(self):
        return 0 if self.spec.start_tsr else 1

    def get_T_mov(self, traj):
        return jax.lax.dynamic_slice_in_dim(traj, self.mov_lo, self.spec.m, 0)

    def set_T_mov(self, traj, T_mov):
        return jax.lax.dynamic_update_slice_in_dim(traj, T_mov, self.mov_lo, 0)

    # -- cost --------------------------------------------------------------

    def _cost_and_grad(self, prob: ChompProblem, want_grad: bool):
        c, G, kin = cost_mod.total_cost_grad(
            self.spec, self.fk, self.fields, self.same_link,
            self.radii_act, self.radii_all, prob, want_grad)
        if self.extra_cost is not None:
            # chomp.c:495-501: extra cost is added *after* the 1/m scaling
            ce, Ge = self.extra_cost(self.get_T_mov(prob.traj))
            c = c + ce
            if want_grad:
                G = G + Ge
        return c, G, kin

    def smooth_cost(self, prob: ChompProblem, T_mov):
        """tr(½TᵀAT + BᵀT) + trC  (chomp.c:660-677)."""
        AT = self.apply_A(T_mov)
        return (0.5 * jnp.sum(T_mov * AT) + jnp.sum(prob.B * T_mov)
                + prob.trC)

    def costs_only(self, prob: ChompProblem):
        """Final cost report without an update (cd_chomp_iterate with
        do_iteration=0, orcdchomp_mod.cpp:2830-2831)."""
        c_obs, _, _ = self._cost_and_grad(prob, want_grad=False)
        c_smooth = self.smooth_cost(prob, self.get_T_mov(prob.traj))
        return c_obs + c_smooth, c_obs, c_smooth

    # -- HMC ---------------------------------------------------------------

    def _maybe_resample(self, prob: ChompProblem):
        """HMC momentum resampling (orcdchomp_mod.cpp:2754-2768):
        at resample iterations AG ~ N(0, 1/√α) with α = 100·e^{0.02·iter},
        and the next resample iteration is 1 + Exp(λ_resample) away.
        ``hmc_resample_lambda`` rides in through resample_iter scheduling
        at problem build (see api.create)."""
        spec = self.spec
        if not spec.use_hmc:
            return prob.AG, prob.hmc
        it = prob.iteration
        key, k_noise, k_exp = jax.random.split(prob.hmc.key, 3)
        alpha = 100.0 * jnp.exp(0.02 * it.astype(self.dtype))
        noise = jax.random.normal(k_noise, prob.AG.shape, self.dtype) \
            / jnp.sqrt(alpha)
        do = it == prob.hmc.resample_iter
        AG = jnp.where(do, noise, prob.AG)
        leap = jnp.where(do, True, prob.hmc.leapfrog_first)
        u = jax.random.uniform(k_exp, (), self.dtype, minval=1e-12)
        gap = 1 + jnp.floor(-jnp.log(u) / prob.hmc_resample_lambda
                            ).astype(jnp.int32)
        nxt = jnp.where(do, it + gap, prob.hmc.resample_iter)
        return AG, HmcState(key=key, resample_iter=nxt, leapfrog_first=leap)

    # -- joint limits ------------------------------------------------------

    def _limit_repair(self, T_mov, lo, hi):
        """Iterative joint-limit repair (chomp.c:608-655)."""

        def cond(carry):
            _, cnt, done = carry
            return (~done) & (cnt < _MAX_LIMIT_FIXES)

        def body(carry):
            T, cnt, _ = carry
            Gj = jnp.where(T < lo, lo - T, 0.0) + jnp.where(T > hi, hi - T, 0.0)
            absG = jnp.abs(Gj).ravel()
            amax = jnp.argmax(absG)
            viol = absG[amax]
            pred = viol > 0.0
            GjA = self.solve_A(Gj)
            denom = GjA.ravel()[amax]
            scale = 1.01 * Gj.ravel()[amax] / jnp.where(denom == 0.0, 1.0, denom)
            T_new = T + scale * GjA
            return (jnp.where(pred, T_new, T), cnt + 1, ~pred)

        T, cnt, _ = jax.lax.while_loop(
            cond, body, (T_mov, jnp.int32(0), jnp.array(False)))
        return T, cnt

    # -- the step ----------------------------------------------------------

    def step(self, prob: ChompProblem):
        """One CHOMP iteration.  Returns (next_problem,
        (cost_total, cost_obs, cost_smooth)) — obstacle cost measured on
        the incoming trajectory, smoothness on the updated one, exactly
        as the reference reports them (chomp.c:475-491, 658-677)."""
        spec = self.spec
        lam = prob.lambda_
        T_mov = self.get_T_mov(prob.traj)

        AG, hmc = self._maybe_resample(prob)

        # phase scopes mirror the reference's DEBUG_TIMING taxonomy
        # (chomp.h:95-100, orcdchomp_mod.cpp:2835-2847); they land in
        # op_name metadata, where profiler traces attribute device time
        with jax.named_scope("callbacks"):
            c_obs, G, kin = self._cost_and_grad(prob, want_grad=True)

        with jax.named_scope("smoothgrad"):
            # smoothness gradient (chomp.c:515-522)
            G = G + self.apply_A(T_mov) + prob.B

            if not spec.use_momentum:
                AG_new = self.solve_A(G)
                leap = hmc.leapfrog_first
            else:
                # leapfrog half step on first use (chomp.c:533-548)
                scale = jnp.where(hmc.leapfrog_first, 0.5, 1.0) / lam
                AG_new = AG + scale * self.solve_A(G)
                leap = jnp.zeros_like(hmc.leapfrog_first)

        # constraint projection (chomp.c:553-600)
        if self.cons.k_total:
            with jax.named_scope("constraint"):
                val, jac = eval_tsr_all(spec, self.fk, prob, prob.traj,
                                        self.cons, kin)
                T_mov = T_mov + project_constraints(
                    spec, self.cons, self, lam, AG_new, T_mov, val, jac)

        # gradient descent step (chomp.c:604-605)
        T_mov = T_mov - AG_new / lam

        # joint limits
        with jax.named_scope("limits"):
            T_mov, _ = self._limit_repair(T_mov, prob.jlimit_lower,
                                          prob.jlimit_upper)

        # smooth cost on the updated *pre-renorm* trajectory, exactly
        # where cd_chomp_iterate computes it (chomp.c:660-677)
        c_smooth = self.smooth_cost(prob, T_mov)

        traj = self.set_T_mov(prob.traj, T_mov)
        if spec.floating_base:
            # per-iteration quaternion renormalization happens *after*
            # the core iteration (orcdchomp_mod.cpp:2805-2808)
            traj = jnp.concatenate(
                [qt.pose_normalize(traj[:, :7]), traj[:, 7:]], axis=1)

        new_prob = prob._replace(
            traj=traj, AG=AG_new,
            hmc=HmcState(key=hmc.key, resample_iter=hmc.resample_iter,
                         leapfrog_first=leap),
            iteration=prob.iteration + 1,
        )
        return new_prob, (c_obs + c_smooth, c_obs, c_smooth)

    # -- batch-native (SoA) step -------------------------------------------
    #
    # A structure-of-arrays twin of step() for the unconstrained
    # fixed-base case: the cost path runs with the problem batch axis
    # minor (cost_soa.py), every other stage is written directly on the
    # (B, m, n) batch instead of being vmapped.  Numerically equivalent
    # to vmap(step) (tests/test_soa_batch.py); the vmapped AoS layout
    # puts tiny 3/4/7-wide component axes minor on the self-collision,
    # FK and Jᵀ tensors, which this layout avoids (ops/soa.py).

    @property
    def batch_native_ok(self) -> bool:
        # start_tsr shifts the moving-point window and extra_cost is an
        # arbitrary per-problem callable — both keep the vmapped path
        return not self.spec.start_tsr and self.extra_cost is None

    def apply_A_b(self, X):
        """A · X for X (B, m, n)."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            return mm.sep_apply_A(X, self.spec.dt)
        return jnp.einsum("ij,bjn->bin", self.A, X, precision="highest")

    def solve_A_b(self, G):
        """A⁻¹ · G for G (B, m, n)."""
        if self.metric_mode == "sep":
            from or_cdchomp_jax.chomp import metric as mm
            return mm.sep_solve(G, self.spec.dt)
        return jnp.einsum("ij,bjn->bin", self.Ainv, G, precision="highest")

    def _limit_repair_batched(self, T, lo, hi):
        """Batched joint-limit repair (chomp.c:608-655): each problem
        repairs its own worst violation per round; rounds continue while
        any problem still violates (identical fixpoint to vmapping
        :meth:`_limit_repair`)."""
        B, m, n = T.shape
        lo = lo[:, None, :]
        hi = hi[:, None, :]

        def cond(carry):
            _, cnt, done = carry
            return (~done) & (cnt < _MAX_LIMIT_FIXES)

        def body(carry):
            T, cnt, _ = carry
            Gj = jnp.where(T < lo, lo - T, 0.0) + \
                jnp.where(T > hi, hi - T, 0.0)
            Gf = Gj.reshape(B, -1)
            amax = jnp.argmax(jnp.abs(Gf), axis=1)             # (B,)
            gmax = jnp.take_along_axis(Gf, amax[:, None], axis=1)[:, 0]
            pred = jnp.abs(gmax) > 0.0                          # (B,)
            GjA = self.solve_A_b(Gj)
            denom = jnp.take_along_axis(
                GjA.reshape(B, -1), amax[:, None], axis=1)[:, 0]
            scale = 1.01 * gmax / jnp.where(denom == 0.0, 1.0, denom)
            T_new = T + scale[:, None, None] * GjA
            T = jnp.where(pred[:, None, None], T_new, T)
            return (T, cnt + 1, ~jnp.any(pred))

        T, _, _ = jax.lax.while_loop(
            cond, body, (T, jnp.int32(0), jnp.array(False)))
        return T

    def step_batched(self, probs: ChompProblem):
        """One CHOMP iteration over a (B,)-batched problem pytree.
        Returns (next_probs, costs (B, 3))."""
        from or_cdchomp_jax.chomp import cost_soa
        _ablate = cost_soa._ABLATE

        spec = self.spec
        m = spec.m
        lam = probs.lambda_                                    # (B,)
        T_mov = probs.traj[:, 1:1 + m]                          # (B, m, n)

        AG, hmc = jax.vmap(self._maybe_resample)(probs)

        with jax.named_scope("callbacks"):
            c_obs, G, fk_out = cost_soa.total_cost_grad_batched(
                spec, self.fk, self.fields, self.same_link,
                self.radii_act, self.radii_all, probs)

        with jax.named_scope("smoothgrad"):
            G = G + self.apply_A_b(T_mov) + probs.B
            if not spec.use_momentum:
                AG_new = self.solve_A_b(G)
                leap = hmc.leapfrog_first
            else:
                scale = (jnp.where(hmc.leapfrog_first, 0.5, 1.0) / lam
                         )[:, None, None]
                AG_new = AG + scale * self.solve_A_b(G)
                leap = jnp.zeros_like(hmc.leapfrog_first)

        # constraint projection (chomp.c:553-600): evaluation runs
        # batch-native (eval_tsr_all_soa, free of the vmapped-AoS
        # chain's (…, 6, 7)-minor tensors and stack_pose_aos
        # relayouts; CDX_TSR_EVAL=aos keeps the old path A/B-able);
        # the projection solve stays vmapped per problem on small
        # (C, k) blocks
        if self.cons.k_total and "constraint" not in _ablate:
            with jax.named_scope("constraint"):
                if ("constraint_eval" in _ablate
                        or "constraint_math" in _ablate):
                    # measurement-only: input-dependent stand-ins of
                    # the right shapes; "constraint_eval" drops the
                    # whole chain (incl. any relayouts),
                    # "constraint_math" keeps the AoS relayouts live so
                    # their wall can be separated from the chain math
                    Bn = probs.traj.shape[0]
                    C = self.cons.n_constraints
                    n = spec.n
                    seed = 1e-6 * jnp.mean(T_mov)
                    if "constraint_math" in _ablate:
                        red_aos = cost_soa.stack_pose_aos(
                            fk_out.red_pos, fk_out.red_q)
                        anch_aos = cost_soa.stack_pose_aos(
                            fk_out.anch_pos, fk_out.anch_q)
                        seed = seed + 1e-9 * (jnp.mean(red_aos)
                                              + jnp.mean(anch_aos))
                    val = jnp.full((Bn, C, 6), 0.0, T_mov.dtype) + seed
                    jac = jnp.full((Bn, C, 6, n), 0.0,
                                   T_mov.dtype) + seed
                elif _TSR_EVAL == "aos":
                    from or_cdchomp_jax.chomp.cost import TrajKinematics

                    red_aos = cost_soa.stack_pose_aos(
                        fk_out.red_pos, fk_out.red_q)  # (B, n_pts, R, 7)
                    anch_aos = cost_soa.stack_pose_aos(
                        fk_out.anch_pos, fk_out.anch_q)

                    def eval_one(traj, red, anch, p):
                        z = traj[:0]
                        kin = TrajKinematics(
                            x_all=z, x_mov=z, vel=z, acc=z, anchors_mov=z,
                            base_mov=z, red_poses=red, anchors=anch)
                        return eval_tsr_all(spec, self.fk, p, traj,
                                            self.cons, kin)

                    val, jac = jax.vmap(eval_one)(
                        probs.traj, red_aos, anch_aos, probs)
                else:
                    val, jac = eval_tsr_all_soa(
                        spec, self.fk, probs, probs.traj, self.cons,
                        fk_out)

                def proj_one(lam_, ag, tm, v, j):
                    return project_constraints(
                        spec, self.cons, self, lam_, ag, tm, v, j)

                if "constraint_proj" not in _ablate:
                    T_mov = T_mov + jax.vmap(proj_one)(
                        lam, AG_new, T_mov, val, jac)

        T_mov = T_mov - AG_new / lam[:, None, None]

        with jax.named_scope("limits"):
            if "limits" not in _ablate:   # measurement-only stub
                T_mov = self._limit_repair_batched(
                    T_mov, probs.jlimit_lower, probs.jlimit_upper)

        with jax.named_scope("smoothcost"):
            AT = self.apply_A_b(T_mov)
            c_smooth = (0.5 * jnp.sum(T_mov * AT, axis=(1, 2))
                        + jnp.sum(probs.B * T_mov, axis=(1, 2))
                        + probs.trC)

        traj = jax.lax.dynamic_update_slice_in_dim(
            probs.traj, T_mov, 1, axis=1)
        if spec.floating_base:
            # per-iteration quaternion renorm (orcdchomp_mod.cpp:2805-2808)
            traj = jnp.concatenate(
                [qt.pose_normalize(traj[..., :7]), traj[..., 7:]], axis=-1)
        new_probs = probs._replace(
            traj=traj, AG=AG_new,
            hmc=HmcState(key=hmc.key, resample_iter=hmc.resample_iter,
                         leapfrog_first=leap),
            iteration=probs.iteration + 1,
        )
        costs = jnp.stack([c_obs + c_smooth, c_obs, c_smooth], axis=-1)
        return new_probs, costs

    def iterate_batched_nojit(self, probs: ChompProblem, n_iter: int):
        """Batch-native scan; same contract as vmap(iterate_nojit):
        returns (probs, costs (B, n_iter, 3))."""
        def body(p, _):
            p, costs = self.step_batched(p)
            return p, costs

        probs, costs = jax.lax.scan(body, probs, None, length=n_iter,
                                    unroll=_ITER_UNROLL)
        return probs, jnp.moveaxis(costs, 0, 1)

    # -- drivers -----------------------------------------------------------
    # Every driver jit is PER-ENGINE (created lazily, owned by the
    # engine instance): a class-level @jit(static_argnums=(0,)) would
    # key its global cache on the engine object, pinning every engine
    # ever created — plus the FieldStack device buffers baked into its
    # executables as constants — for the life of the process.  The
    # module-level engine cache (api._evict_engines) relies on dropped
    # engines actually freeing their HBM.

    def _jitted(self, name, impl, static_argnums=()):
        d = self.__dict__.setdefault("_jits", {})
        w = d.get(name)
        if w is None:
            w = jax.jit(impl, static_argnums=static_argnums)
            d[name] = w
        return w

    def iterate(self, prob: ChompProblem, n_iter: int):
        """n_iter steps via lax.scan; returns (problem, costs (n_iter, 3))."""
        return self._jitted("iterate", self._iterate_impl, (1,))(
            prob, n_iter)

    def _iterate_impl(self, prob: ChompProblem, n_iter: int):
        def body(p, _):
            p, costs = self.step(p)
            return p, jnp.stack(costs)

        prob, costs = jax.lax.scan(body, prob, None, length=n_iter)
        return prob, costs

    # fixed chunk length of the masked driver: one compiled executable
    # per engine serves every (n_iter, max_time) pattern.  Not yet
    # measured on the H100.
    ITER_CHUNK = 16

    def iterate_masked(self, prob: ChompProblem, valid, chunk_size=None):
        if chunk_size is None:
            chunk_size = self.ITER_CHUNK
        return self._jitted("iterate_masked", self._iterate_masked_impl,
                            (2,))(prob, valid, chunk_size)

    def _iterate_masked_impl(self, prob: ChompProblem, valid, chunk_size):
        """``chunk_size`` steps with the first ``valid`` (a *traced*
        scalar) applied and the rest passed through unchanged.  Unlike
        :meth:`iterate`, whose executable is specialized on the static
        n_iter, this compiles once per (engine, chunk_size) bucket — the
        api-level driver uses chunk_size ∈ {1, ITER_CHUNK} so varying
        n_iter / max_time budgets / tail chunks never recompile, and
        per-iteration callers (max_time / trajs_fileformstr force
        chunk=1) execute exactly ONE step per applied iteration instead
        of paying all ITER_CHUNK steps and discarding 15.  Returns
        (problem, costs (chunk_size, 3)); rows ≥ valid are garbage and
        the caller slices them off."""
        valid = jnp.asarray(valid, jnp.int32)
        if chunk_size == 1:
            # single-step bucket: mask the lone step on valid > 0 so a
            # valid=0 caller gets a pure pass-through (the documented
            # "first valid applied" contract; api.iterate never sends
            # valid=0 but the bucket must not rely on that)
            prob2, costs = self.step(prob)
            take = valid > 0
            prob = jax.tree.map(lambda a, b: jnp.where(take, a, b),
                                prob2, prob)
            return prob, jnp.stack(costs)[None]

        def body(p, i):
            p2, costs = self.step(p)
            take = i < valid
            p2 = jax.tree.map(lambda a, b: jnp.where(take, a, b), p2, p)
            return p2, jnp.stack(costs)

        prob, costs = jax.lax.scan(body, prob,
                                   jnp.arange(chunk_size, dtype=jnp.int32))
        return prob, costs

    def costs_only_jit(self, prob: ChompProblem):
        return self._jitted("costs_only", self.costs_only)(prob)

    def iterate_batch(self, probs: ChompProblem, n_iter: int):
        """Batched: probs has a leading problem axis on every leaf.
        Uses the batch-native SoA step when the problem class allows,
        vmap of the per-problem step otherwise."""
        return self._jitted("iterate_batch", self._iterate_batch_impl,
                            (1,))(probs, n_iter)

    def _iterate_batch_impl(self, probs: ChompProblem, n_iter: int):
        if self.batch_native_ok:
            return self.iterate_batched_nojit(probs, n_iter)

        def one(p):
            return self.iterate_nojit(p, n_iter)

        return jax.vmap(one)(probs)

    def iterate_nojit(self, prob, n_iter):
        def body(p, _):
            p, costs = self.step(p)
            return p, jnp.stack(costs)

        return jax.lax.scan(body, prob, None, length=n_iter)

    def final_costs_batch(self, probs):
        return self._jitted(
            "final_costs_batch",
            lambda ps: jax.vmap(self.costs_only)(ps))(probs)
