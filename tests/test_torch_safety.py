"""The port's safety stage against the JAX package's, module by module, on
the same seeded inputs: scenario and solution XMLs byte for byte, the
converters, the primitive banks element for element, the collision
decisions of the two native libraries (and of the port's numpy version),
the planner's trajectories and statistics, and the metrics. Tolerance is
exact throughout, but for the numpy collision test within rounding of
touching (counted)."""
import dataclasses
import math
import os

import numpy as np
import pytest

from eval_driving_safety_tpu.config import PlannerConfig as JPlannerConfig
from eval_driving_safety_tpu.data import kitti as JK
from eval_driving_safety_tpu.safety import collision as JC
from eval_driving_safety_tpu.safety import commonroad_io as JIO
from eval_driving_safety_tpu.safety import convert as JCV
from eval_driving_safety_tpu.safety import metrics as JM
from eval_driving_safety_tpu.safety import planner as JP
from eval_driving_safety_tpu.safety import primitives as JPR
from eval_driving_safety_tpu.safety import templates as JT
from eval_driving_safety_tpu_torch.config import PlannerConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.safety import collision as PC
from eval_driving_safety_tpu_torch.safety import commonroad_io as PIO
from eval_driving_safety_tpu_torch.safety import convert as PCV
from eval_driving_safety_tpu_torch.safety import metrics as PM
from eval_driving_safety_tpu_torch.safety import planner as PP
from eval_driving_safety_tpu_torch.safety import primitives as PPR
from eval_driving_safety_tpu_torch.safety import templates as PT


def _same(jax_obj, port_obj):
    """Equal dataclass trees (numpy arrays element for element): the reprs
    with the package names aligned."""
    return repr(jax_obj).replace("eval_driving_safety_tpu.",
                                 "eval_driving_safety_tpu_torch.") == \
        repr(port_obj)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- IO ---------------------------------------------------------------------

def _scenario(io, tpl):
    """The left highway template with every element kind, awkward strings,
    an empty bound, integer and f32 points and a dynamic obstacle without
    states."""
    sc = tpl.make_init_scenario("left", "11_13")
    sc.author = 'a&b <"c">\n\t'
    sc.static_obstacles.append(io.StaticObstacle(
        2001, "parked & Vehicle", io.RectShape(np.float64(4.0), 1.7),
        io.State(position=np.array([12.0, -2.0]), orientation=0.3)))
    sc.dynamic_obstacles.append(io.DynamicObstacle(
        2002, "car", io.RectShape(4.1, 1.75),
        io.State(position=np.array([1.0, 2.0]), velocity=7.1),
        io.Trajectory(1, [io.State(position=np.array([1.1, 2.0 + i / 3]),
                                   time_step=i + 1, velocity=7.3)
                          for i in range(3)])))
    sc.dynamic_obstacles.append(io.DynamicObstacle(
        2003, "", io.RectShape(4.0, 1.7),
        io.State(position=(np.float32(0.1), 2)), io.Trajectory(1, [])))
    sc.lanelets.append(io.Lanelet(99, np.zeros((0, 2)),
                                  np.array([[1, 2], [3, 4]]),
                                  lanelet_type=""))
    sc.lanelets.append(io.Lanelet(100, np.array([[1.5, 2.1]], np.float32),
                                  np.array([[1e-7, 2e20], [-0.0, 5e-324]]),
                                  adjacent_left=(3, "opposite")))
    return sc


def test_scenario_xml_byte_identical_and_cross_readable(tmp_path):
    jp, pp = str(tmp_path / "j.xml"), str(tmp_path / "p.xml")
    JIO.write_scenario(_scenario(JIO, JT), jp)
    PIO.write_scenario(_scenario(PIO, PT), pp)
    assert _bytes(jp) == _bytes(pp)
    assert _same(JIO.read_scenario(pp), PIO.read_scenario(jp))
    # without lanelets: the same obstacles and problems
    full, bare = PIO.read_scenario(jp), PIO.read_scenario(jp, lanelets=False)
    assert not bare.lanelets and full.lanelets
    for field in ("static_obstacles", "dynamic_obstacles",
                  "planning_problems", "benchmark_id", "dt", "author"):
        assert repr(getattr(full, field)) == repr(getattr(bare, field))


def test_reading_without_lanelets_parses_it_all_where_a_cut_could_hide(
        tmp_path):
    """An obstacle between two lanelets: the cut would drop it, so the
    reader parses the whole file."""
    sc = PT.make_init_scenario()
    sc.lanelets = sc.lanelets[:2]
    sc.static_obstacles.append(PIO.StaticObstacle(
        7, "parkedVehicle", PIO.RectShape(4.0, 1.7),
        PIO.State(position=np.array([9.0, 0.5]))))
    path = str(tmp_path / "s.xml")
    PIO.write_scenario(sc, path)
    text = _bytes(path)
    start = text.index(b"  <staticObstacle")
    end = text.index(b"</staticObstacle>") + len(b"</staticObstacle>\n")
    obstacle = text[start:end]
    text = text[:start] + text[end:]
    second = text.index(b"  <lanelet id=\"2\"")
    with open(path, "wb") as f:
        f.write(text[:second] + obstacle + text[second:])
    bare = PIO.read_scenario(path, lanelets=False)
    assert [o.obstacle_id for o in bare.static_obstacles] == [7]
    assert _same(JIO.read_scenario(path).static_obstacles,
                 bare.static_obstacles)


def test_solution_xml_byte_identical_and_cross_readable(tmp_path):
    for sid, n in (("000042", 7), ("000043", 1), ("000044", 0)):
        def states(io):
            r = np.random.RandomState(n)
            return [io.State(position=r.randn(2) * 10,
                             orientation=float(r.randn()),
                             velocity=float(r.uniform(6, 8)),
                             steering_angle=None if i % 3 else float(
                                 r.randn()), time_step=i)
                    for i in range(n)]
        jp = JIO.write_solution(str(tmp_path / "j"), sid,
                                JIO.Trajectory(0, states(JIO)), 100)
        pp = PIO.write_solution(str(tmp_path / "p"), sid,
                                PIO.Trajectory(0, states(PIO)), 100)
        assert os.path.basename(jp) == os.path.basename(pp)
        assert _bytes(jp) == _bytes(pp)
        assert _same(JIO.read_solution(pp), PIO.read_solution(jp))


def test_six_templates_byte_identical(tmp_path):
    jpaths = JT.write_templates(str(tmp_path / "j"))
    ppaths = PT.write_templates(str(tmp_path / "p"))
    assert [os.path.relpath(p, tmp_path / "j") for p in jpaths] == \
        [os.path.relpath(p, tmp_path / "p") for p in ppaths]
    for a, b in zip(jpaths, ppaths):
        assert _bytes(a) == _bytes(b)


# -- conversion -------------------------------------------------------------

TYPES = ("Car", "Car", "Van", "Truck", "Misc", "Pedestrian", "Cyclist",
         "DontCare")


def _label_lines(rng, n, score=False):
    lines = []
    for _ in range(n):
        fields = [TYPES[rng.randint(len(TYPES))], "0.00", "0",
                  f"{rng.uniform(-3, 3):.2f}",
                  *(f"{v:.2f}" for v in rng.uniform(0, 400, 4)),
                  *(f"{v:.2f}" for v in rng.uniform(0.5, 5, 3)),
                  f"{rng.uniform(-15, 15):.2f}", f"{rng.uniform(1, 2):.2f}",
                  f"{rng.uniform(4, 45):.2f}",
                  f"{rng.uniform(-math.pi, math.pi):.2f}"]
        if score:
            fields.append(f"{rng.uniform(0, 1):.8f}")
        lines.append(" ".join(fields))
    return lines


def _codes(rng, n):
    return [("n", "0", "1", "-1", " 1 ")[rng.randint(5)] for _ in range(n)]


def _render(sc, tmp_path, name):
    """A scenario's XML (either package's objects) through the port's
    writer, whose bytes equal the JAX writer's (tests above)."""
    path = str(tmp_path / name)
    PIO.write_scenario(sc, path)
    return _bytes(path)


@pytest.mark.parametrize("seed", range(8))
def test_converters_match(seed, tmp_path):
    rng = np.random.RandomState(seed)
    lines = _label_lines(rng, rng.randint(0, 14), score=seed % 2 == 1)
    codes = _codes(rng, len(lines))
    jobj = [JK.KittiObject.from_line(ln) for ln in lines]
    pobj = [TK.KittiObject.from_line(ln) for ln in lines]
    for hw in (False, True):
        direction = ("straight", "left", "right")[seed % 3]
        a = JCV.convert_detection_scenario(jobj, hw, direction)
        b = PCV.convert_detection_scenario(pobj, hw, direction)
        assert a._next_id == b._next_id
        assert _render(a, tmp_path, "j.xml") == _render(b, tmp_path, "p.xml")
        for annos in (codes, None):
            a = JCV.convert_gt_scenario(jobj, annos, hw, direction,
                                        seed=seed * 7)
            b = PCV.convert_gt_scenario(pobj, annos, hw, direction,
                                        seed=seed * 7)
            assert a._next_id == b._next_id
            assert _render(a, tmp_path, "j.xml") == \
                _render(b, tmp_path, "p.xml")


def _labeled_tree(root, seed=0):
    rng = np.random.RandomState(seed)
    k = 0
    for sub, anno, n in (("static_label", None, 3),
                         ("dynamic_label", "dynamic_annotation", 2),
                         ("road_dynamic_label", "road_dynamic_annotation",
                          3)):
        os.makedirs(os.path.join(root, "kl", sub))
        if anno:
            os.makedirs(os.path.join(root, "kl", anno))
        for i in range(n):
            fid = f"{100 + 37 * k:06d}"
            k += 1
            lines = _label_lines(rng, rng.randint(0, 10))
            with open(os.path.join(root, "kl", sub, fid + ".txt"), "w") as f:
                f.write("".join(ln + "\n" for ln in lines))
            # one dynamic frame without its annotation file: all static
            if anno and i > 0:
                with open(os.path.join(root, "kl", anno, fid + ".txt"),
                          "w") as f:
                    f.write("".join(c + "\n" for c in
                                    _codes(rng, len(lines))))
            os.makedirs(os.path.join(root, "det"), exist_ok=True)
            with open(os.path.join(root, "det", fid + ".txt"), "w") as f:
                f.write("".join(ln + "\n" for ln in _label_lines(
                    rng, rng.randint(0, 10), score=True)))


def test_folder_drivers_write_identical_trees(tmp_path):
    root = str(tmp_path)
    _labeled_tree(root)
    kl = os.path.join(root, "kl")
    jw = JCV.convert_gt_folder(kl, os.path.join(root, "jg"), seed=5)
    pw = PCV.convert_gt_folder(kl, os.path.join(root, "pg"), seed=5)
    jd = JCV.convert_detection_folder(
        os.path.join(root, "det"), os.path.join(root, "jd"),
        os.path.join(kl, "road_dynamic_label"), "right")
    pd = PCV.convert_detection_folder(
        os.path.join(root, "det"), os.path.join(root, "pd"),
        os.path.join(kl, "road_dynamic_label"), "right")
    assert len(jw) == len(pw) == 8 and len(jd) == len(pd) == 8
    for a, b in zip(jw + jd, pw + pd):
        assert os.path.basename(a) == os.path.basename(b)
        assert _bytes(a) == _bytes(b)


# -- primitives -------------------------------------------------------------

@pytest.mark.parametrize("highway", [False, True])
def test_primitive_banks_equal(highway):
    a = JPR.primitives_for_band(highway)
    b = PPR.primitives_for_band(highway)
    assert len(a) == len(b) > 20
    for p, q in zip(a, b):
        assert (p.v_start, p.v_end, p.sa_start, p.sa_end) == \
            (q.v_start, q.v_end, q.sa_start, q.sa_end)
        assert np.array_equal(p.states, q.states)
    w = PPR.transform_states(b[3].states, 1.5, -2.0, 0.7)
    assert np.array_equal(w, JPR.transform_states(a[3].states, 1.5, -2.0,
                                                  0.7))


# -- collision --------------------------------------------------------------

def _margin(a, b):
    """The largest gap between the boxes' projections over the four
    axes: > 0 separates them."""
    out = -np.inf
    ca, sa, cb, sb = np.cos(a[2]), np.sin(a[2]), np.cos(b[2]), np.sin(b[2])
    for ax, ay in ((ca, sa), (-sa, ca), (cb, sb), (-sb, cb)):
        dist = abs((b[0] - a[0]) * ax + (b[1] - a[1]) * ay)
        ra = a[3] / 2 * abs(ax * ca + ay * sa) + a[4] / 2 * abs(-ax * sa
                                                                 + ay * ca)
        rb = b[3] / 2 * abs(ax * cb + ay * sb) + b[4] / 2 * abs(-ax * sb
                                                                 + ay * cb)
        out = max(out, dist - (ra + rb))
    return out


def _pairs(n=2000, seed=0):
    """Random pairs, and pairs a few ulp from touching: edge to edge
    along an axis (axis-aligned and at a shared angle) and corner to
    edge."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n // 2):
        a = [*rng.uniform(-5, 5, 2), rng.uniform(-math.pi, math.pi),
             *rng.uniform(0.5, 6, 2)]
        b = [*rng.uniform(-5, 5, 2), rng.uniform(-math.pi, math.pi),
             *rng.uniform(0.5, 6, 2)]
        pairs.append((a, b))
    for k in range(n // 2):
        theta = (0.0, math.pi / 2, rng.uniform(-math.pi, math.pi))[k % 3]
        la, wa, lb, wb = rng.uniform(0.5, 6, 4)
        gap = (la + lb) / 2
        cx, cy = rng.uniform(-5, 5, 2)
        off = rng.uniform(-0.4, 0.4) * min(wa, wb)
        d = np.nextafter(gap, np.inf * rng.choice((-1, 1)))
        for _ in range(rng.randint(0, 4)):
            d = np.nextafter(d, np.inf * rng.choice((-1, 1)))
        c, s = math.cos(theta), math.sin(theta)
        a = [cx, cy, theta, la, wa]
        b = [cx + d * c - off * s, cy + d * s + off * c, theta, lb, wb]
        pairs.append((a, b))
    return [(np.array(a), np.array(b)) for a, b in pairs]


def test_collision_decisions_match_the_jax_library():
    assert JC.get_native() is not None, "the JAX package's library"
    pairs = _pairs()
    port = [PC.obb_intersect(a, b) for a, b in pairs]
    jax_lib = [JC.obb_intersect(a, b) for a, b in pairs]
    assert port == jax_lib
    assert 300 < sum(port) < len(pairs) - 300
    # the numpy version: the same but within rounding of touching
    plain = [PC.obb_overlap_plain(a, b) for a, b in pairs]
    differ = [i for i, (p, q) in enumerate(zip(port, plain)) if p != q]
    assert all(abs(_margin(*pairs[i])) < 1e-12 for i in differ)
    assert len(differ) <= 20, len(differ)


@pytest.mark.parametrize("seed", range(6))
def test_first_collision_arrays_match(seed):
    rng = np.random.RandomState(seed)
    t = 20
    ego = np.column_stack([np.arange(t), np.cumsum(rng.uniform(0, 1.5, t)),
                           rng.uniform(-1, 1, t), rng.uniform(-0.3, 0.3, t),
                           np.full(t, 4.508), np.full(t, 1.61)])
    stat = np.column_stack([rng.uniform(0, 40, 10), rng.uniform(-6, 6, 10),
                            rng.uniform(-3, 3, 10), rng.uniform(3, 5, 10),
                            rng.uniform(1.5, 2, 10)])
    dyn = np.column_stack([rng.randint(0, t, 40), rng.uniform(0, 40, 40),
                           rng.uniform(-6, 6, 40), rng.uniform(-3, 3, 40),
                           np.full(40, 4.0), np.full(40, 1.8)])
    for s, d in ((stat, dyn), (stat[:0], dyn), (stat, dyn[:0]),
                 (stat[:0], dyn[:0])):
        want = JC.first_collision_arrays(ego, s, d)
        assert PC.first_collision_arrays(ego, s, d) == want
        assert PC.first_collision_arrays_plain(ego, s, d) == want


def test_a_collision_core_that_cannot_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PC, "_lib", None)
    monkeypatch.setattr(PC, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(PC, "CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="cannot build the collision"):
        PC.first_collision_arrays(np.zeros((1, 6)), np.zeros((0, 5)),
                                  np.zeros((0, 6)))
    assert not list(tmp_path.iterdir())


def test_a_collision_core_that_cannot_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PC, "_lib", None)
    monkeypatch.setattr(PC, "BUILD_DIR", tmp_path)
    PC.library_path().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load the collision"):
        PC.obb_intersect(np.zeros(5), np.zeros(5))


def test_the_collision_core_builds_into_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(PC, "_lib", None)
    monkeypatch.setattr(PC, "BUILD_DIR", tmp_path)
    assert PC.obb_intersect(np.array([0, 0, 0, 4, 2.0]),
                            np.array([3.9, 0, 0, 4, 2.0]))
    assert [p.name for p in tmp_path.iterdir()] == [PC.library_path().name]


# -- planner ----------------------------------------------------------------

def _planner_scenarios():
    """24 scenarios built by both packages: 20 seeded street and highway
    scenes (static and dynamic obstacles from GT labels with codes), two
    with a wall across the road (the search empties its open set) and two
    with the goal covered under a small expansion cap (it stops there)."""
    out = []
    for seed in range(20):
        rng = np.random.RandomState(100 + seed)
        lines = []
        for _ in range(rng.randint(1, 9)):
            x = rng.choice((-1, 1)) * rng.uniform(2.5, 9)
            ry = rng.choice((-0.5, 0.5)) * math.pi + rng.normal(0, 0.2)
            lines.append(f"Car 0.00 0 0.00 0 0 10 10 1.50 1.70 4.00 "
                         f"{x:.2f} 1.60 {rng.uniform(5, 35):.2f} {ry:.2f}")
        codes = [("0", "1")[rng.randint(2)] for _ in lines]
        hw = seed % 2 == 1
        direction = ("straight", "left", "right")[seed % 3]
        pair = [conv.convert_gt_scenario(
            [kk.KittiObject.from_line(ln) for ln in lines], codes, hw,
            direction, seed=seed) for conv, kk in ((JCV, JK), (PCV, TK))]
        out.append((*pair, hw, None))
    for x, size, cap in ((6.0, 2.0, None), (7.0, 2.0, None),
                         (15.0, 6.0, 300), (14.5, 7.0, 300)):
        pair = []
        for io, tpl in ((JIO, JT), (PIO, PT)):
            sc = tpl.make_init_scenario("straight", "6_8")
            ys = np.arange(-12.0, 12.1, 2.0) if cap is None else [0.0]
            for y in ys:
                sc.static_obstacles.append(io.StaticObstacle(
                    sc.generate_object_id(), "parkedVehicle",
                    io.RectShape(size, size),
                    io.State(position=np.array([x, y]))))
            pair.append(sc)
        out.append((*pair, False, cap))
    return out


def test_planner_trajectories_and_stats_match():
    failed, exhausted, capped = 0, 0, 0
    for jsc, psc, hw, cap in _planner_scenarios():
        jcfg, pcfg = JPlannerConfig(), PlannerConfig()
        if cap is not None:
            jcfg = dataclasses.replace(jcfg, max_expansions=cap)
            pcfg = dataclasses.replace(pcfg, max_expansions=cap)
        jp = JP.AStarPlanner(jsc, jsc.planning_problems[0],
                             JPR.primitives_for_band(hw, jcfg), jcfg)
        a, stats = jp.plan(), {}
        b = PP.plan_scenario(psc, hw, pcfg, stats=stats)
        assert stats == jp.stats
        assert _same(a, b)          # (no path here has one state)
        if a is None:
            failed += 1
            exhausted += stats["exhausted"]
            capped += stats["expansions"] == cap
    assert failed >= 2 and exhausted >= 1 and capped >= 1


# -- metrics ----------------------------------------------------------------

def test_evaluate_all_matches(tmp_path):
    root = str(tmp_path)
    _labeled_tree(root, seed=3)
    kl = os.path.join(root, "kl")
    PCV.convert_gt_folder(kl, os.path.join(root, "gt"))
    PCV.convert_detection_folder(os.path.join(root, "det"),
                                 os.path.join(root, "sc"))
    names = sorted(os.listdir(os.path.join(root, "sc")))
    for name in names:
        sc = PIO.read_scenario(os.path.join(root, "sc", name), False)
        traj = PP.plan_scenario(sc, False)
        if traj is not None:
            PIO.write_solution(os.path.join(root, "sol"), name[:6], traj,
                               100)
    a = JM.evaluate_all(os.path.join(root, "sc"), os.path.join(root, "sol"),
                        os.path.join(root, "gt"))
    b = PM.evaluate_all(os.path.join(root, "sc"), os.path.join(root, "sol"),
                        os.path.join(root, "gt"))
    assert a.as_dict() == b.as_dict() and a.colliding_ids == b.colliding_ids
    assert 0 < b.num_solutions <= b.num_scenarios == len(names)
