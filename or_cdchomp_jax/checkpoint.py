"""Checkpoint / resume for solver state and SDF fields.

The reference has two persistence mechanisms (SURVEY.md §5):
 1. the SDF binary cache (orcdchomp_mod.cpp:416-444 / 570-580), covered
    by computedistancefield's cache_filename (api.py);
 2. de-facto optimizer resume: create/iterate/gettraj are separable and
    iterate is re-entrant on a run handle; a run can be seeded from a
    prior trajectory via starttraj.

This module adds first-class checkpointing of the *batched* solver
pytree (the new-build equivalent of both): save/restore a ChompProblem
(single or batched) plus its iteration bookkeeping with orbax, so a
pod-scale sweep can stop and resume across jobs.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from or_cdchomp_jax.chomp.problem import ChompProblem, HmcState


def _flatten(problem: ChompProblem) -> dict:
    leaves, _ = jax.tree.flatten(problem)
    return {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}


def save_problem(path: str, problem: ChompProblem) -> None:
    """Save a (possibly batched) problem pytree to ``path`` (.npz)."""
    try:
        import orbax.checkpoint as ocp

        ckpt = ocp.StandardCheckpointer()
        ckpt.save(os.path.abspath(path), jax.device_get(problem), force=True)
        ckpt.wait_until_finished()
        return
    except (ImportError, ValueError, TypeError):
        # orbax unavailable or rejects the pytree: portable npz fallback
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 **_flatten(problem))


def load_problem(path: str, template: ChompProblem) -> ChompProblem:
    """Restore a problem saved by :func:`save_problem`.

    ``template`` supplies the pytree structure (and dtypes/sharding for
    orbax restoration).
    """
    try:
        import orbax.checkpoint as ocp

        if os.path.isdir(path):
            ckpt = ocp.StandardCheckpointer()
            return ckpt.restore(os.path.abspath(path),
                                jax.device_get(template))
    except ImportError:
        pass
    npz = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz)
    leaves, treedef = jax.tree.flatten(template)
    new_leaves = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, new_leaves)
