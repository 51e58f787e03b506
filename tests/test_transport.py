"""shparse tokenizer, kdata XML, and SendCommand transport tests."""

import json

import numpy as np
import pytest

import or_cdchomp_jax as oc
from or_cdchomp_jax.api import KinBody, Robot
from or_cdchomp_jax.models.kdata import parse_spheres_xml, with_spheres
from or_cdchomp_jax.utils.shparse import shparse, shquot


def test_shparse_basic():
    assert shparse("create robot 'my robot' n_points 11") == \
        ["create", "robot", "my robot", "n_points", "11"]


def test_shparse_quotes_escapes():
    assert shparse("a 'b c' \"d e\" f\\ g") == ["a", "b c", "d e", "f g"]
    assert shparse("x 'it'\\''s'") == ["x", "it's"]
    assert shparse("") == []


def test_shquot_roundtrip():
    for s in ["simple", "two words", "it's", "a'b'c", ""]:
        assert shparse("cmd " + shquot(s)) == ["cmd", s]


def test_shparse_errors():
    with pytest.raises(ValueError):
        shparse("'unterminated")
    with pytest.raises(ValueError):
        shparse("trailing\\")


def test_kdata_parse_reference_fixture():
    """Parse the reference's WAM sphere fixture format
    (barrettwam_withspheres.robot.xml:22-46)."""
    xml = """
    <Robot name="BarrettWAM"><KinBody>
      <orcdchomp><spheres>
        <sphere link="wam0" pos=" 0.22  0.14 0.346" radius="0.15" />
        <sphere link="wam2" pos=" 0.0   0.0  0.2 " radius="0.06" />
      </spheres></orcdchomp>
    </KinBody></Robot>"""
    spheres = parse_spheres_xml(xml)
    assert spheres[0] == ("wam0", (0.22, 0.14, 0.346), 0.15)
    assert spheres[1] == ("wam2", (0.0, 0.0, 0.2), 0.06)


def test_kdata_no_tag():
    with pytest.raises(ValueError, match="orcdchomp"):
        parse_spheres_xml("<Robot><KinBody/></Robot>")


def test_kdata_with_spheres():
    model = oc.wam7()
    spheres = [("wam2", (0, 0, 0.25), 0.07)]
    m2 = with_spheres(model, spheres)
    assert len(m2.sphere_radius) == 1
    assert m2.sphere_radius[0] == 0.07
    with pytest.raises(ValueError, match="does not exist"):
        with_spheres(model, [("nolink", (0, 0, 0), 0.1)])


@pytest.fixture(scope="module")
def world():
    mod = oc.CHOMPModule()
    mod.add_kinbody(KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = Robot("wam", oc.wam7(),
              q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(r)
    return mod, r


def test_send_command_full_flow(world):
    """The reference wire protocol end to end: computedistancefield →
    create → iterate → gettraj → destroy as command strings."""
    mod, r = world
    r.enabled = False
    mod.SendCommand("computedistancefield kinbody 'table' cube_extent 0.15")
    r.enabled = True
    run = mod.SendCommand(
        "create robot 'wam' adofgoal '0.6 0.7 0.1 1.4 0.0 -0.3 0.0' "
        "lambda 100.0000 obs_factor 500.000000 n_points 8 no_report_cost")
    assert run.startswith("run")
    cost = float(mod.SendCommand(f"iterate run {run} n_iter 2"))
    assert np.isfinite(cost)
    out = mod.SendCommand(f"gettraj run {run} no_collision_check")
    data = json.loads(out)
    assert len(data["positions"]) == 8
    assert mod.SendCommand(f"destroy run {run}") == ""


def test_send_command_bad_arg(world):
    mod, r = world
    with pytest.raises(ValueError, match="not known"):
        mod.SendCommand("iterate bogus 1")


def test_no_report_cost_suppresses_reporting(world):
    """no_report_cost (documented README.md:137, unparseable in the
    reference — fixed here) turns off per-iteration cost rows."""
    mod, r = world
    if not mod.sdfs:   # independent of test ordering
        r.enabled = False
        mod.SendCommand("computedistancefield kinbody table cube_extent 0.15")
        r.enabled = True
    goal = "'0.6 0.7 0.1 1.4 0.0 -0.3 0.0'"
    h1 = mod.SendCommand(f"create robot wam adofgoal {goal} n_points 9 "
                         "no_report_cost")
    mod.SendCommand(f"iterate run {h1} n_iter 3")
    assert mod.runs[h1].dat_rows == []
    h2 = mod.SendCommand(f"create robot wam adofgoal {goal} n_points 9")
    mod.SendCommand(f"iterate run {h2} n_iter 3")
    assert len(mod.runs[h2].dat_rows) == 3
    mod.SendCommand(f"destroy run {h1}")
    mod.SendCommand(f"destroy run {h2}")


def test_no_report_cost_still_writes_dat_file(world, tmp_path):
    """no_report_cost disables *reporting* only: the .dat rows are
    written unconditionally when dat_filename is set (the reference's
    fprintf to fp_dat is unconditional, orcdchomp_mod.cpp:2810-2818)."""
    mod, r = world
    if not mod.sdfs:
        r.enabled = False
        mod.SendCommand("computedistancefield kinbody table cube_extent 0.15")
        r.enabled = True
    dat = str(tmp_path / "costs.dat")
    goal = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
    h = mod.create(robot="wam", adofgoal=goal, n_points=9,
                   no_report_cost=True, dat_filename=dat)
    mod.iterate(run=h, n_iter=3)
    assert len(mod.runs[h].dat_rows) == 3
    with open(dat) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    assert len(lines) == 3
    mod.destroy(run=h)
