"""Time of the safety stage with the port's XML writes and reads against
ElementTree's, over one corpus.

The port writes scenario and solution XMLs as text (safety/commonroad_io.py,
`_Xml`) and, where only obstacles and problems count (planning and the
collision check), reads a scenario with its lanelets cut out
(`read_scenario(path, lanelets=False)`). This runs the stage's CLIs
(convert_gt_scenarios, convert_scenarios and plan_motion with
--dyna_obj_folder, check_collision --check_all, eval --json) over a
`kitti_labeled` tree and a folder of detection txts four times: as they
are (`text`); with the plain IO (`etree`), which builds both kinds of
file as ElementTree trees, indents them with `ET.indent` and writes them
with `ElementTree.write`, as the JAX package does, and parses every
scenario whole; with the text writer formatting every lanelet bound
anew (`text_uncached`, no cache of a bound's text); and as they are
again. Every run must write the same bytes (the scenarios, solutions and
collision.txt) and print the same metrics.
Prints one JSON line: each stage's seconds in each run. Runs on the
host.

    python -m eval_driving_safety_tpu_torch.cli.safety_io_split \\
        --input_folder kitti_labeled --det_folder det --work /tmp/io
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import time
from xml.etree import ElementTree as ET

from eval_driving_safety_tpu_torch.cli import (check_collision,
                                                convert_gt_scenarios,
                                                convert_scenarios,
                                                eval as eval_cli,
                                                plan_motion)
from eval_driving_safety_tpu_torch.safety import collision, convert
from eval_driving_safety_tpu_torch.safety import commonroad_io as cio


# -- the plain writers: ElementTree trees, ET.indent, ElementTree.write ------

def _sub(parent, tag, text=None, **attrs):
    el = ET.SubElement(parent, tag, {k: str(v) for k, v in attrs.items()})
    if text is not None:
        el.text = str(text)
    return el


def _point(parent, xy):
    p = _sub(parent, "point")
    _sub(p, "x", f"{xy[0]}")
    _sub(p, "y", f"{xy[1]}")


def _exact(parent, tag, value):
    _sub(_sub(parent, tag), "exact", value)


def _interval(parent, tag, start, end):
    el = _sub(parent, tag)
    _sub(el, "intervalStart", start)
    _sub(el, "intervalEnd", end)


def _state(parent, tag, s, with_kinematics=False):
    el = _sub(parent, tag)
    _point(_sub(el, "position"), s.position)
    _exact(el, "orientation", s.orientation)
    _exact(el, "time", s.time_step)
    _exact(el, "velocity", s.velocity)
    if with_kinematics:
        _exact(el, "yawRate", s.yaw_rate or 0.0)
        _exact(el, "slipAngle", s.slip_angle or 0.0)


def _save(root, path):
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, encoding="UTF-8", xml_declaration=True)


def write_scenario_etree(sc, path):
    root = ET.Element("commonRoad", {
        "timeStepSize": str(sc.dt), "commonRoadVersion": "2020a",
        "author": sc.author, "affiliation": sc.affiliation, "source": "",
        "benchmarkID": sc.benchmark_id, "date": "2026-01-01"})
    loc = _sub(root, "location")
    _sub(loc, "geoNameId", -999)
    _sub(loc, "gpsLatitude", 999.0)
    _sub(loc, "gpsLongitude", 999.0)
    tags = _sub(root, "scenarioTags")
    _sub(tags, "interstate")
    _sub(tags, "critical")
    for ll in sc.lanelets:
        lel = _sub(root, "lanelet", id=ll.lanelet_id)
        for tag, bound in (("leftBound", ll.left_bound),
                           ("rightBound", ll.right_bound)):
            b = _sub(lel, tag)
            for p in bound:
                _point(b, p)
        for tag, adj in (("adjacentLeft", ll.adjacent_left),
                         ("adjacentRight", ll.adjacent_right)):
            if adj:
                _sub(lel, tag, ref=adj[0], drivingDir=adj[1])
        _sub(lel, "laneletType", ll.lanelet_type)
    for kind, obs in (("staticObstacle", sc.static_obstacles),
                      ("dynamicObstacle", sc.dynamic_obstacles)):
        for ob in obs:
            oel = _sub(root, kind, id=ob.obstacle_id)
            _sub(oel, "type", ob.obstacle_type)
            rect = _sub(_sub(oel, "shape"), "rectangle")
            _sub(rect, "length", ob.shape.length)
            _sub(rect, "width", ob.shape.width)
            _state(oel, "initialState", ob.initial_state)
            if kind == "dynamicObstacle":
                tr = _sub(oel, "trajectory")
                for s in ob.trajectory.states:
                    _state(tr, "state", s)
    for pp in sc.planning_problems:
        g = pp.goal
        pel = _sub(root, "planningProblem", id=pp.problem_id)
        _state(pel, "initialState", pp.initial_state, with_kinematics=True)
        goal = _sub(pel, "goalState")
        rect = _sub(_sub(goal, "position"), "rectangle")
        _sub(rect, "length", g.position.length)
        _sub(rect, "width", g.position.width)
        _sub(rect, "orientation", g.position.orientation)
        c = _sub(rect, "center")
        _sub(c, "x", g.position.center[0])
        _sub(c, "y", g.position.center[1])
        _interval(goal, "orientation", g.orientation.start, g.orientation.end)
        _interval(goal, "time", int(g.time.start), int(g.time.end))
        _interval(goal, "velocity", g.velocity.start, g.velocity.end)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _save(root, path)


def write_solution_etree(output_dir, scenario_id, trajectory,
                         planning_problem_id):
    root = ET.Element("CommonRoadSolution", {
        "benchmark_id": cio.solution_benchmark_id(scenario_id),
        "date": "2026-01-01"})
    tr = _sub(_sub(root, "planningProblemSolution",
                   planningProblem=planning_problem_id), "trajectory")
    for s in trajectory.states:
        sel = _sub(tr, "state")
        _point(_sub(sel, "position"), s.position)
        _exact(sel, "orientation", s.orientation)
        _exact(sel, "time", s.time_step)
        _exact(sel, "velocity", s.velocity)
        _exact(sel, "steeringAngle", s.steering_angle or 0.0)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, cio.solution_file_name(scenario_id))
    _save(root, path)
    return path


def read_scenario_whole(path, lanelets=True):
    """Every scenario parsed whole, lanelets and all."""
    return cio.read_scenario(path)


@contextlib.contextmanager
def plain_io():
    """The stage's modules with the plain writers and whole reads."""
    patches = [(convert, "write_scenario", write_scenario_etree),
               (plan_motion, "write_solution", write_solution_etree),
               (plan_motion, "read_scenario", read_scenario_whole),
               (collision, "read_scenario", read_scenario_whole),
               (check_collision, "read_scenario", read_scenario_whole)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def uncached_bounds():
    """The text writer without its cache of a bound's text."""
    cached = cio._points_text
    cio._points_text = cached.__wrapped__
    try:
        yield
    finally:
        cio._points_text = cached


IO = {"text": contextlib.nullcontext, "etree": plain_io,
      "text_uncached": uncached_bounds}


# -- the chain ---------------------------------------------------------------

def chain(labeled, det, work):
    """The five CLIs over `labeled` and `det` into `work` (also the working
    directory, for collision.txt). Returns (seconds a stage, eval's JSON
    line, {relative path: sha256} of every file written)."""
    dyna = os.path.join(labeled, "road_dynamic_label")
    gt, sc, sol = (os.path.join(work, d)
                   for d in ("gt", "scenarios", "solutions"))
    stages = (
        ("convert_gt", convert_gt_scenarios.main,
         ["--input_folder", labeled, "--output_folder", gt]),
        ("convert", convert_scenarios.main,
         ["--input_folder", det, "--output_folder", sc,
          "--dyna_obj_folder", dyna]),
        ("plan", plan_motion.main,
         ["--input_folder", sc, "--output_folder", sol,
          "--dyna_obj_folder", dyna]),
        ("check", check_collision.main,
         ["--check_all", "--scenario_path", gt, "--solution_path", sol]),
        ("eval", eval_cli.main,
         ["--scenario_path", sc, "--solution_path", sol,
          "--gt_scenario_path", gt, "--json"]))
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    secs = {}
    try:
        for name, main, args in stages:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                main(args)
            secs[name] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    digest = {}
    for d, _, files in os.walk(work):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                digest[os.path.relpath(os.path.join(d, f), work)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return secs, out.getvalue().strip().splitlines()[-1], digest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input_folder", required=True,
                   help="a kitti_labeled tree (the GT)")
    p.add_argument("--det_folder", required=True,
                   help="detection txts, one a frame")
    p.add_argument("--work", required=True,
                   help="an empty or missing folder for the runs' files")
    args = p.parse_args(argv)
    labeled, det, work = (os.path.abspath(a) for a in (
        args.input_folder, args.det_folder, args.work))
    runs = []
    for k, io_name in enumerate(("text", "etree", "text_uncached", "text")):
        run = os.path.join(work, f"run{k}")
        with IO[io_name]():
            secs, metrics, digest = chain(labeled, det, run)
        shutil.rmtree(run)
        runs.append({"io": io_name, "stage_s": secs,
                     "total_s": sum(secs.values())})
        if k == 0:
            first = (metrics, digest)
        elif (metrics, digest) != first:
            raise SystemExit(f"run {k} ({io_name}) wrote other bytes or "
                             f"metrics than run 0")
    print(json.dumps({"safety_io_split": {
        "scenarios": sum(n.startswith("scenarios") for n in first[1]),
        "files_compared": len(first[1]), "metrics": json.loads(first[0]),
        "runs": runs}}), flush=True)
    return runs


if __name__ == "__main__":
    main()
