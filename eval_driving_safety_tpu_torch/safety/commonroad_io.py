"""CommonRoad 2020a XML, the subset the safety stage reads and writes.

Counterpart of eval_driving_safety_tpu/safety/commonroad_io.py: the same
data model, and files byte for byte the same. Scenario and solution XMLs
are written as `xml.etree.ElementTree` writes the JAX package's trees
after `ET.indent` (two spaces a level, `<tag />` for an element with
neither text nor children, attributes in insertion order, the
`<?xml version='1.0' encoding='UTF-8'?>` declaration, no final newline),
with every number as `str(value)`. The text is emitted directly, not
through element objects: a scenario holds 27 lanelets of 200 points a
bound, about 32,500 elements, and building, indenting and serializing
them is most of a write's time. A bound's text is kept by its bytes, so a
template's lanelets are formatted once per process.

`read_scenario(path, lanelets=False)` skips the lanelets (most of a
file), which the planner and the collision checker never read.
`cli/safety_io_split.py` times the stage with this IO and with
ElementTree's.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple
from xml.etree import ElementTree as ET

import numpy as np


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------

@dataclass
class State:
    position: np.ndarray            # (2,)
    orientation: float = 0.0
    time_step: int = 0
    velocity: float = 0.0
    steering_angle: Optional[float] = None
    yaw_rate: Optional[float] = None
    slip_angle: Optional[float] = None


@dataclass
class Trajectory:
    initial_time_step: int
    states: List[State]


@dataclass
class RectShape:
    length: float
    width: float
    orientation: float = 0.0
    center: Tuple[float, float] = (0.0, 0.0)


@dataclass
class StaticObstacle:
    obstacle_id: int
    obstacle_type: str              # e.g. "parkedVehicle"
    shape: RectShape
    initial_state: State


@dataclass
class DynamicObstacle:
    obstacle_id: int
    obstacle_type: str              # e.g. "car"
    shape: RectShape
    initial_state: State
    trajectory: Trajectory


@dataclass
class Interval:
    start: float
    end: float


@dataclass
class GoalState:
    position: RectShape
    orientation: Interval
    time: Interval
    velocity: Interval


@dataclass
class PlanningProblem:
    problem_id: int
    initial_state: State
    goal: GoalState


@dataclass
class Lanelet:
    lanelet_id: int
    left_bound: np.ndarray          # (N, 2)
    right_bound: np.ndarray         # (N, 2)
    lanelet_type: str = "urban"
    adjacent_left: Optional[Tuple[int, str]] = None
    adjacent_right: Optional[Tuple[int, str]] = None


@dataclass
class Scenario:
    benchmark_id: str
    dt: float = 0.1
    lanelets: List[Lanelet] = field(default_factory=list)
    static_obstacles: List[StaticObstacle] = field(default_factory=list)
    dynamic_obstacles: List[DynamicObstacle] = field(default_factory=list)
    planning_problems: List[PlanningProblem] = field(default_factory=list)
    author: str = ""
    affiliation: str = ""

    _next_id: int = 1000

    def generate_object_id(self) -> int:
        self._next_id += 1
        return self._next_id


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _f(el, tag, default=None):
    c = el.find(tag)
    return float(c.text) if c is not None and c.text else default


def _exact_or_interval(el):
    """Returns (exact, Interval) — one of the two is None."""
    if el is None:
        return None, None
    e = el.find("exact")
    if e is not None:
        return float(e.text), None
    s, t = el.find("intervalStart"), el.find("intervalEnd")
    if s is not None:
        return None, Interval(float(s.text), float(t.text))
    return None, None


def _parse_point(el):
    return np.array([_f(el, "x"), _f(el, "y")])


def _parse_bound(el):
    return np.array([[_f(p, "x"), _f(p, "y")] for p in el.findall("point")])


def _parse_state(el) -> State:
    pos_el = el.find("position/point")
    pos = _parse_point(pos_el) if pos_el is not None else np.zeros(2)
    orient, _ = _exact_or_interval(el.find("orientation"))
    t, _ = _exact_or_interval(el.find("time"))
    v, _ = _exact_or_interval(el.find("velocity"))
    yr, _ = _exact_or_interval(el.find("yawRate"))
    sa, _ = _exact_or_interval(el.find("slipAngle"))
    st, _ = _exact_or_interval(el.find("steeringAngle"))
    return State(position=pos, orientation=orient or 0.0,
                 time_step=int(t or 0), velocity=v or 0.0,
                 steering_angle=st, yaw_rate=yr, slip_angle=sa)


def _parse_rect(el) -> RectShape:
    center_el = el.find("center")
    center = ((float(_f(center_el, "x")), float(_f(center_el, "y")))
              if center_el is not None else (0.0, 0.0))
    return RectShape(length=_f(el, "length"), width=_f(el, "width"),
                     orientation=_f(el, "orientation", 0.0), center=center)


_LANELET_START = re.compile(rb"<lanelet[\s/>]")
_LANELET_END = b"</lanelet>"
_KEPT_STARTS = (b"<staticObstacle", b"<dynamicObstacle", b"<planningProblem")


def _root_without_lanelets(data: bytes):
    """The document's root with the run of text from its first lanelet to
    the end of its last cut out, or None where that run could hold an
    element the reader takes (the caller then parses it all)."""
    m = _LANELET_START.search(data)
    end = data.rfind(_LANELET_END)
    if m is None or end < m.start():
        return None
    run = data[m.start():end + len(_LANELET_END)]
    if any(tag in run for tag in _KEPT_STARTS):
        return None
    try:
        return ET.fromstring(
            data[:m.start()] + data[end + len(_LANELET_END):])
    except ET.ParseError:
        return None


def read_scenario(path: str, lanelets: bool = True) -> Scenario:
    """Read a scenario XML. With `lanelets=False` the scenario comes back
    without lanelets, and its next obstacle id counts the obstacles' ids
    only."""
    root = None
    if not lanelets:
        with open(path, "rb") as f:
            root = _root_without_lanelets(f.read())
    if root is None:
        root = ET.parse(path).getroot()
    sc = Scenario(
        benchmark_id=root.get("benchmarkID", ""),
        dt=float(root.get("timeStepSize", "0.1")),
        author=root.get("author", ""),
        affiliation=root.get("affiliation", ""),
    )
    max_id = 1000
    for lel in root.findall("lanelet") if lanelets else ():
        lid = int(lel.get("id"))
        max_id = max(max_id, lid)
        adj_l = lel.find("adjacentLeft")
        adj_r = lel.find("adjacentRight")
        sc.lanelets.append(Lanelet(
            lanelet_id=lid,
            left_bound=_parse_bound(lel.find("leftBound")),
            right_bound=_parse_bound(lel.find("rightBound")),
            lanelet_type=(lel.findtext("laneletType") or "urban").strip(),
            adjacent_left=(int(adj_l.get("ref")), adj_l.get("drivingDir"))
            if adj_l is not None else None,
            adjacent_right=(int(adj_r.get("ref")), adj_r.get("drivingDir"))
            if adj_r is not None else None,
        ))
    for oel in root.findall("staticObstacle"):
        oid = int(oel.get("id"))
        max_id = max(max_id, oid)
        sc.static_obstacles.append(StaticObstacle(
            obstacle_id=oid,
            obstacle_type=(oel.findtext("type") or "parkedVehicle").strip(),
            shape=_parse_rect(oel.find("shape/rectangle")),
            initial_state=_parse_state(oel.find("initialState")),
        ))
    for oel in root.findall("dynamicObstacle"):
        oid = int(oel.get("id"))
        max_id = max(max_id, oid)
        states = [_parse_state(s) for s in
                  oel.findall("trajectory/state")]
        init = _parse_state(oel.find("initialState"))
        sc.dynamic_obstacles.append(DynamicObstacle(
            obstacle_id=oid,
            obstacle_type=(oel.findtext("type") or "car").strip(),
            shape=_parse_rect(oel.find("shape/rectangle")),
            initial_state=init,
            trajectory=Trajectory(states[0].time_step if states else 1,
                                  states),
        ))
    for pel in root.findall("planningProblem"):
        goal_el = pel.find("goalState")
        _, orient_iv = _exact_or_interval(goal_el.find("orientation"))
        _, time_iv = _exact_or_interval(goal_el.find("time"))
        _, vel_iv = _exact_or_interval(goal_el.find("velocity"))
        sc.planning_problems.append(PlanningProblem(
            problem_id=int(pel.get("id")),
            initial_state=_parse_state(pel.find("initialState")),
            goal=GoalState(
                position=_parse_rect(goal_el.find("position/rectangle")),
                orientation=orient_iv or Interval(-np.pi, np.pi),
                time=time_iv or Interval(0, 1000),
                velocity=vel_iv or Interval(0.0, 100.0),
            ),
        ))
    sc._next_id = max_id
    return sc


# ---------------------------------------------------------------------------
# Writing: ElementTree's bytes, emitted as text
# ---------------------------------------------------------------------------

_DECLARATION = "<?xml version='1.0' encoding='UTF-8'?>\n"


def _esc(text: str) -> str:
    """Character data, escaped as ElementTree escapes it."""
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(
        ">", "&gt;")


def _attrs(**attrs) -> str:
    """` k="v"` for each attribute, escaped as ElementTree escapes them."""
    return "".join(
        ' {}="{}"'.format(k, _esc(v).replace('"', "&quot;").replace(
            "\r", "&#13;").replace("\n", "&#10;").replace("\t", "&#09;"))
        for k, v in attrs.items())


def _points_of(depth: int, rows) -> str:
    p0 = "\n" + "  " * depth
    p1 = p0 + "  "
    return "".join(
        f"{p0}<point>{p1}<x>{r[0]}</x>{p1}<y>{r[1]}</y>{p0}</point>"
        for r in rows)


@lru_cache(maxsize=256)
def _points_text(depth: int, shape: tuple, data: bytes) -> str:
    """The points of an f64 array, by its bytes: every scenario carries
    its template's 54 lanelet bounds, so each is formatted once."""
    rows = np.frombuffer(data, np.float64).reshape(shape)
    return _points_of(depth, rows.tolist())   # floats format as np.float64


class _Xml:
    """An indented document: each element on its own line, two spaces a
    level below the root."""

    def __init__(self, root: str, attrs: str):
        self.root = root
        self.parts = [_DECLARATION, f"<{root}{attrs}>"]

    def leaf(self, depth: int, tag: str, value=None, attrs: str = ""):
        """An element without children: `str(value)` as its text, or
        `<tag />` where that is empty or `value` is None."""
        text = "" if value is None else str(value)
        pad = "\n" + "  " * depth
        if text:
            self.parts.append(f"{pad}<{tag}{attrs}>{_esc(text)}</{tag}>")
        else:
            self.parts.append(f"{pad}<{tag}{attrs} />")

    def node(self, depth: int, tag: str, children, attrs: str = ""):
        """An element whose children `children(depth + 1)` emits;
        `<tag />` where it emits none."""
        pad = "\n" + "  " * depth
        at = len(self.parts)
        self.parts.append(f"{pad}<{tag}{attrs}>")
        children(depth + 1)
        if len(self.parts) == at + 1:
            self.parts[at] = f"{pad}<{tag}{attrs} />"
        else:
            self.parts.append(f"{pad}</{tag}>")

    def points(self, depth: int, rows):
        """A `<point>` element of each row's first two entries, as
        f"{v}"."""
        if isinstance(rows, np.ndarray) and rows.dtype == np.float64:
            text = _points_text(depth, rows.shape, rows.tobytes())
        else:
            text = _points_of(depth, rows)
        if text:
            self.parts.append(text)

    def save(self, path: str):
        self.parts.append(f"\n</{self.root}>")
        with open(path, "w", encoding="UTF-8",
                  errors="xmlcharrefreplace") as f:
            f.write("".join(self.parts))


def _write_exact(x: _Xml, depth: int, tag: str, value):
    x.node(depth, tag, lambda d: x.leaf(d, "exact", value))


def _write_interval(x: _Xml, depth: int, tag: str, start, end):
    def kids(d):
        x.leaf(d, "intervalStart", start)
        x.leaf(d, "intervalEnd", end)
    x.node(depth, tag, kids)


def _write_position(x: _Xml, depth: int, xy):
    x.node(depth, "position", lambda d: x.points(d, [xy]))


def _write_state(x: _Xml, depth: int, tag: str, s: State,
                 with_kinematics=False):
    def kids(d):
        _write_position(x, d, s.position)
        _write_exact(x, d, "orientation", s.orientation)
        _write_exact(x, d, "time", s.time_step)
        _write_exact(x, d, "velocity", s.velocity)
        if with_kinematics:
            _write_exact(x, d, "yawRate", s.yaw_rate or 0.0)
            _write_exact(x, d, "slipAngle", s.slip_angle or 0.0)
    x.node(depth, tag, kids)


def _write_rect(x: _Xml, depth: int, r: RectShape):
    def rect(d):
        x.leaf(d, "length", r.length)
        x.leaf(d, "width", r.width)
    x.node(depth, "shape", lambda d: x.node(d, "rectangle", rect))


def _write_lanelet(x: _Xml, ll: Lanelet):
    def kids(d):
        x.node(d, "leftBound", lambda e: x.points(e, ll.left_bound))
        x.node(d, "rightBound", lambda e: x.points(e, ll.right_bound))
        if ll.adjacent_left:
            x.leaf(d, "adjacentLeft", attrs=_attrs(
                ref=str(ll.adjacent_left[0]),
                drivingDir=str(ll.adjacent_left[1])))
        if ll.adjacent_right:
            x.leaf(d, "adjacentRight", attrs=_attrs(
                ref=str(ll.adjacent_right[0]),
                drivingDir=str(ll.adjacent_right[1])))
        x.leaf(d, "laneletType", ll.lanelet_type)
    x.node(1, "lanelet", kids, _attrs(id=str(ll.lanelet_id)))


def _write_problem(x: _Xml, pp: PlanningProblem):
    g = pp.goal

    def goal_rect(d):
        x.leaf(d, "length", g.position.length)
        x.leaf(d, "width", g.position.width)
        x.leaf(d, "orientation", g.position.orientation)

        def center(e):
            x.leaf(e, "x", g.position.center[0])
            x.leaf(e, "y", g.position.center[1])
        x.node(d, "center", center)

    def goal(d):
        x.node(d, "position", lambda e: x.node(e, "rectangle", goal_rect))
        _write_interval(x, d, "orientation", g.orientation.start,
                        g.orientation.end)
        _write_interval(x, d, "time", int(g.time.start), int(g.time.end))
        _write_interval(x, d, "velocity", g.velocity.start, g.velocity.end)

    def kids(d):
        _write_state(x, d, "initialState", pp.initial_state,
                     with_kinematics=True)
        x.node(d, "goalState", goal)
    x.node(1, "planningProblem", kids, _attrs(id=str(pp.problem_id)))


def write_scenario(sc: Scenario, path: str) -> None:
    x = _Xml("commonRoad", _attrs(
        timeStepSize=str(sc.dt), commonRoadVersion="2020a",
        author=sc.author, affiliation=sc.affiliation, source="",
        benchmarkID=sc.benchmark_id, date="2026-01-01"))

    def location(d):
        x.leaf(d, "geoNameId", -999)
        x.leaf(d, "gpsLatitude", 999.0)
        x.leaf(d, "gpsLongitude", 999.0)

    def tags(d):
        x.leaf(d, "interstate")
        x.leaf(d, "critical")
    x.node(1, "location", location)
    x.node(1, "scenarioTags", tags)
    for ll in sc.lanelets:
        _write_lanelet(x, ll)
    for ob in sc.static_obstacles:
        def kids(d, ob=ob):
            x.leaf(d, "type", ob.obstacle_type)
            _write_rect(x, d, ob.shape)
            _write_state(x, d, "initialState", ob.initial_state)
        x.node(1, "staticObstacle", kids, _attrs(id=str(ob.obstacle_id)))
    for ob in sc.dynamic_obstacles:
        def kids(d, ob=ob):
            x.leaf(d, "type", ob.obstacle_type)
            _write_rect(x, d, ob.shape)
            _write_state(x, d, "initialState", ob.initial_state)
            x.node(d, "trajectory", lambda e: [
                _write_state(x, e, "state", s)
                for s in ob.trajectory.states])
        x.node(1, "dynamicObstacle", kids, _attrs(id=str(ob.obstacle_id)))
    for pp in sc.planning_problems:
        _write_problem(x, pp)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x.save(path)


# ---------------------------------------------------------------------------
# Solutions
# ---------------------------------------------------------------------------

def solution_benchmark_id(scenario_id: str, vehicle: str = "KS1",
                          cost: str = "SM1") -> str:
    return f"{vehicle}:{cost}:{scenario_id}:2020a"


def solution_file_name(scenario_id: str) -> str:
    """`solution_KS1:SM1:<id>:2020a.xml`: characters [17:23] of the name
    are a 6-digit scenario id, which the collision check pairs by."""
    return f"solution_{solution_benchmark_id(scenario_id)}.xml"


def write_solution(output_dir: str, scenario_id: str, trajectory: Trajectory,
                   planning_problem_id: int) -> str:
    x = _Xml("CommonRoadSolution", _attrs(
        benchmark_id=solution_benchmark_id(scenario_id), date="2026-01-01"))

    def state(d, s):
        _write_position(x, d, s.position)
        _write_exact(x, d, "orientation", s.orientation)
        _write_exact(x, d, "time", s.time_step)
        _write_exact(x, d, "velocity", s.velocity)
        _write_exact(x, d, "steeringAngle", s.steering_angle or 0.0)

    def states(d):
        for s in trajectory.states:
            x.node(d, "state", lambda e, s=s: state(e, s))
    x.node(1, "planningProblemSolution",
           lambda d: x.node(d, "trajectory", states),
           _attrs(planningProblem=str(planning_problem_id)))
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, solution_file_name(scenario_id))
    x.save(path)
    return path


def read_solution(path: str) -> Tuple[str, int, Trajectory]:
    """Returns (benchmark_id, planning_problem_id, trajectory)."""
    root = ET.parse(path).getroot()
    pps = root.find("planningProblemSolution")
    states = [_parse_state(s) for s in pps.findall("trajectory/state")]
    return (root.get("benchmark_id", ""),
            int(pps.get("planningProblem", "100")),
            Trajectory(states[0].time_step if states else 0, states))
