"""String-command transport: the orcwrap/SendCommand layer.

The reference receives every operation as a shell-quoted command string
over OpenRAVE's SendCommand, tokenizes it (orcwrap.cpp:37-69 via
cd_util_shparse), and dispatches by the leading token to the nine
module commands with hand-rolled key/value argument loops
(e.g. mod::create, orcdchomp_mod.cpp:1887-2085).

``send_command(mod, text)`` provides the same wire format against
CHOMPModule: the same command names, the same keyword tokens (including
``lambda`` for lambda_), the same flag semantics, and reference-style
outputs (create → run handle string, iterate → final cost, gettraj →
serialized trajectory).  Differences, by design:

 - ``no_report_cost`` is parsed (the reference documents it but fails
   to parse it — the latent "Bad arguments!" bug of orcdchomp.py:162
   noted in SURVEY.md §2.4 — which we fix rather than replicate).
 - addfield_fromobsarray's ``obsarray`` is a path to a .npy file or a
   whitespace list of 0/1 values rather than a raw C pointer.
 - gettraj serializes to JSON instead of OpenRAVE's trajectory XML.
"""

from __future__ import annotations

import json

import numpy as np

from or_cdchomp_jax.tsr import TSR
from or_cdchomp_jax.utils.shparse import shparse


def _floats(tok):
    return [float(v) for v in tok.split()]


def serialize_trajectory(traj) -> str:
    out = {
        "times": np.asarray(traj.times).tolist(),
        "positions": np.asarray(traj.positions).tolist(),
    }
    if traj.base_poses is not None:
        out["base_poses"] = np.asarray(traj.base_poses).tolist()
    return json.dumps(out)


def _parse_kv(argv, spec):
    """Reference-style arg loop: spec maps keyword → ('flag'|callable).
    Raises on unknown arguments like the reference's "Bad arguments!"
    loops."""
    kwargs = {}
    i = 0
    while i < len(argv):
        key = argv[i]
        if key not in spec:
            raise ValueError(f"argument {key} not known!")
        action = spec[key]
        if action == "flag":
            kwargs[key] = True
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"argument {key} needs a value!")
            kwargs[key] = action(argv[i + 1])
            i += 2
    return kwargs


def send_command(mod, text: str) -> str:
    """Dispatch one command string against a CHOMPModule."""
    argv = shparse(text)
    if not argv:
        raise ValueError("empty command")
    cmd, args = argv[0], argv[1:]

    if cmd == "viewspheres":
        kw = _parse_kv(args, {"robot": str})
        mod.viewspheres(**kw)
        return ""

    if cmd == "computedistancefield":
        kw = _parse_kv(args, {
            "kinbody": str, "cube_extent": float, "aabb_padding": float,
            "cache_filename": str, "require_cache": "flag"})
        return mod.computedistancefield(**kw)

    if cmd == "addfield_fromobsarray":
        kw = _parse_kv(args, {
            "kinbody": str, "obsarray": str, "sizes": _floats,
            "lengths": _floats, "pose": _floats})
        obs = kw.pop("obsarray")
        try:
            arr = np.load(obs)
        except (FileNotFoundError, ValueError, OSError):
            arr = np.array([float(v) for v in obs.split()])
        sizes = [int(v) for v in kw.pop("sizes")]
        return mod.addfield_fromobsarray(
            obsarray=arr, sizes=sizes, **kw)

    if cmd == "viewfields":
        mod.viewfields()
        return ""

    if cmd == "removefield":
        kw = _parse_kv(args, {"kinbody": str})
        return mod.removefield(**kw)

    if cmd == "create":
        # keyword tokens of mod::create (orcdchomp_mod.cpp:1887-2085)
        # con_tsr takes TWO values; handle it before the generic loop
        con_tsrs = []
        rest = []
        i = 0
        while i < len(args):
            if args[i] == "con_tsr":
                if i + 2 >= len(args):
                    raise ValueError("con_tsr needs two arguments!")
                first = shparse(args[i + 1])
                ctype = first[0]
                con_tsrs.append((ctype, TSR.parse(args[i + 2])))
                i += 3
            else:
                rest.append(args[i])
                i += 1
        kw = _parse_kv(rest, {
            "robot": str, "adofgoal": _floats, "basegoal": _floats,
            "floating_base": "flag", "lambda": float, "starttraj": str,
            "n_points": int, "derivative": int,
            "start_tsr": TSR.parse, "everyn_tsr": TSR.parse,
            "use_momentum": "flag", "use_hmc": "flag",
            "hmc_resample_lambda": float, "seed": int,
            "epsilon": float, "epsilon_self": float,
            "obs_factor": float, "obs_factor_self": float,
            "no_report_cost": "flag", "dat_filename": str,
            "start_cost": str,
            # parsed+validated but cost-dead in the reference too
            # (orcdchomp_mod.cpp:2036-2078, comment at 1323)
            "ee_force": _floats, "ee_torque_weights": _floats,
        })
        if "start_cost" in kw:
            # the reference smuggles an in-process function pointer as a
            # "%p" string (orcdchomp_mod.cpp:1998-2001) — meaningless
            # over a real wire; pass a callable to CHOMPModule.create
            raise ValueError(
                "start_cost is an in-process extension point; pass a "
                "callable to CHOMPModule.create directly")
        if "lambda" in kw:
            kw["lambda_"] = kw.pop("lambda")
        if "starttraj" in kw:
            st = json.loads(kw.pop("starttraj"))
            kw["starttraj"] = np.asarray(st["positions"] if isinstance(st, dict)
                                         else st)
        if con_tsrs:
            kw["con_tsrs"] = con_tsrs
        return mod.create(**kw)

    if cmd == "iterate":
        kw = _parse_kv(args, {
            "run": str, "n_iter": int, "max_time": float,
            "trajs_fileformstr": str})
        return repr(mod.iterate(**kw))

    if cmd == "gettraj":
        kw = _parse_kv(args, {
            "run": str, "no_collision_check": "flag",
            "no_collision_exception": "flag", "no_collision_details": "flag"})
        return serialize_trajectory(mod.gettraj(**kw))

    if cmd == "destroy":
        kw = _parse_kv(args, {"run": str})
        return mod.destroy(**kw)

    raise ValueError(f"unknown command {cmd!r}")
