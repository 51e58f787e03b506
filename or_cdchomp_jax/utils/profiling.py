"""Phase-level tracing/profiling.

The reference accumulates per-phase CPU timers under DEBUG_TIMING with
a fixed taxonomy — vels / callback_pre (fk, jacobians, pre_velsaccs) /
callbacks (selfcol) / smoothgrad / smoothcost in the core
(chomp.h:95-100, orcdchomp_mod.cpp:954-958) — reported after iterate
(orcdchomp_mod.cpp:2835-2847).

Here the same taxonomy is expressed two ways:

 - ``phase(name)``: a jax.profiler TraceAnnotation + named_scope so the
   phases appear in XLA/perfetto traces captured with
   ``jax.profiler.trace``.
 - ``PhaseTimers``: host-side wall-clock accumulation for coarse
   phases (SDF build, create, iterate chunks) where host timing is
   meaningful, with the reference's report format.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

# the reference phase taxonomy (chomp.h:95-100, orcdchomp_mod.h) plus
# the step sub-phases this build annotates (solver.step, cost.py)
PHASES = (
    "vels", "callback_pre", "fk", "jacobians", "pre_velsaccs",
    "callbacks", "obstacle", "selfcol", "jtmap", "smoothgrad",
    "constraint", "limits", "smoothcost",
)


@contextlib.contextmanager
def phase(name: str):
    """Annotate a trace region (shows up in jax.profiler captures)."""
    with jax.profiler.TraceAnnotation(name):
        with jax.named_scope(name):
            yield


class PhaseTimers:
    """Host wall-clock per-phase accumulator with the reference's
    report format (orcdchomp_mod.cpp:2835-2847)."""

    def __init__(self):
        self.ticks = defaultdict(float)

    @contextlib.contextmanager
    def tic(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ticks[name] += time.perf_counter() - t0

    def report(self) -> str:
        lines = ["Time breakdown:"]
        for name in PHASES:
            if name in self.ticks:
                lines.append(f"  ticks_{name:<14s} {self.ticks[name]:.8f}")
        for name, v in self.ticks.items():
            if name not in PHASES:
                lines.append(f"  ticks_{name:<14s} {v:.8f}")
        return "\n".join(lines)


def capture_trace(dirname: str):
    """Context manager: capture a profiler trace for offline viewing.

    Usage::

        with capture_trace('/tmp/trace'):
            solver.iterate(probs, 100)
    """
    return jax.profiler.trace(dirname)
