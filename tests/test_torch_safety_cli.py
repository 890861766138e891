"""The safety stage's CLIs, the port's against the JAX package's, over
the same seeded `kitti_labeled` corpus (chip_smoke.py's writer, at 9
frames) from tmp_path as the working directory: the same GT and detected
scenarios, solutions and collision.txt byte for byte, the same printouts
and equal metrics; then the chain from the port's tiny DSGN predict on
the CPU, held against the JAX safety CLIs on the same txts; and the
port's numpy plots, whose obstacle pixels lie inside the JAX package's
rectangle corners (the JAX plot CLIs draw with matplotlib, whose pixels
are not the port's)."""
import json
import os
import sys

import numpy as np
import torch

import chip_smoke
from eval_driving_safety_tpu.cli import check_collision as j_check
from eval_driving_safety_tpu.cli import convert_gt_scenarios as j_convert_gt
from eval_driving_safety_tpu.cli import convert_scenarios as j_convert
from eval_driving_safety_tpu.cli import eval as j_eval
from eval_driving_safety_tpu.cli import plan_motion as j_plan
from eval_driving_safety_tpu.safety import plot as JPLOT
from eval_driving_safety_tpu_torch.cli import check_collision as p_check
from eval_driving_safety_tpu_torch.cli import \
    convert_gt_scenarios as p_convert_gt
from eval_driving_safety_tpu_torch.cli import convert_scenarios as p_convert
from eval_driving_safety_tpu_torch.cli import eval as p_eval
from eval_driving_safety_tpu_torch.cli import plan_motion as p_plan
from eval_driving_safety_tpu_torch.cli import plot_scenario as p_plot_scenario
from eval_driving_safety_tpu_torch.cli import plot_solution as p_plot_solution
from eval_driving_safety_tpu_torch.cli import safety_io_split
from eval_driving_safety_tpu_torch.cli.predict_and_save import \
    main as predict_main
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.data import kitti as TK
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.safety import plot as PPLOT
from eval_driving_safety_tpu_torch.safety.commonroad_io import read_scenario

# 4 static, 2 dynamic and 3 road-dynamic frames; seed 21 gives 8 solved
# scenarios of 9, two of them colliding with the ground truth
COUNTS = (("static_label", None, 4),
          ("dynamic_label", "dynamic_annotation", 2),
          ("road_dynamic_label", "road_dynamic_annotation", 3))
SEED = 21


def _jax(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    main()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _chain(pkg, root, det, labeled, monkeypatch, capsys):
    """The five pipeline CLIs of one package in `root` (its working
    directory); returns (check's printout, eval's printout, eval's
    JSON)."""
    convert_gt, convert, plan, check, evaluate = pkg
    run = (lambda m, a: _jax(m, a, monkeypatch)) \
        if convert_gt is j_convert_gt else (lambda m, a: m(a))
    os.makedirs(root)
    monkeypatch.chdir(root)
    dyna = os.path.join(labeled, "road_dynamic_label")
    run(convert_gt.main, ["--input_folder", labeled, "--output_folder",
                          "gt"])
    run(convert.main, ["--input_folder", det, "--output_folder", "sc",
                       "--dyna_obj_folder", dyna])
    run(plan.main, ["--input_folder", "sc", "--output_folder", "sol",
                    "--dyna_obj_folder", dyna])
    capsys.readouterr()
    run(check.main, ["--check_all", "--scenario_path", "gt",
                     "--solution_path", "sol"])
    checked = capsys.readouterr().out
    common = ["--scenario_path", "sc", "--solution_path", "sol",
              "--gt_scenario_path", "gt"]
    run(evaluate.main, common)
    printed = capsys.readouterr().out
    run(evaluate.main, common + ["--json"])
    return checked, printed, json.loads(capsys.readouterr().out)


JAX_CLIS = (j_convert_gt, j_convert, j_plan, j_check, j_eval)
PORT_CLIS = (p_convert_gt, p_convert, p_plan, p_check, p_eval)


def test_the_safety_clis_match_the_jax_package(tmp_path, monkeypatch,
                                               capsys):
    root = str(tmp_path)
    chip_smoke.write_labeled_corpus(root, COUNTS, SEED)
    labeled = os.path.join(root, "kitti_labeled")
    det = os.path.join(root, "det")
    jax_out = _chain(JAX_CLIS, os.path.join(root, "jax"), det, labeled,
                     monkeypatch, capsys)
    port_out = _chain(PORT_CLIS, os.path.join(root, "port"), det, labeled,
                      monkeypatch, capsys)
    assert jax_out == port_out
    metrics = port_out[2]
    assert metrics["num_scenarios"] == 9
    assert metrics["num_solutions"] == 8 and metrics["num_collisions"] == 2
    jax_files, port_files = (_tree(os.path.join(root, k))
                             for k in ("jax", "port"))
    assert jax_files == port_files
    assert sorted({k.split(os.sep)[0] for k in port_files}) == [
        "collision.txt", "gt", "sc", "sol"]
    assert port_files["collision.txt"] == b"2"
    # the plot CLIs over a colliding solution (the JAX package's draw with
    # matplotlib, whose pixels are not the port's: not run here)
    hit = next(k for k in port_files if k.startswith("sol")
               and k[4 + 17:4 + 23] in port_out[0].split())
    sid = hit[4 + 17:4 + 23]
    pngs = []
    for main in (p_plot_scenario, p_plot_solution):
        pngs.append(os.path.join(root, "plots", main.__name__ + ".png"))
        main.main(["--scenario_path", os.path.join(root, "port", "gt",
                                                   sid + ".xml"),
                   "--solution_path", os.path.join(root, "port", hit),
                   "--output", pngs[-1]])
    images = []
    for png in pngs:
        with open(png, "rb") as f:
            images.append(TK.decode_png_rgb(f.read()))
    assert images[0].shape == (600, 1000, 3)
    assert np.array_equal(*images)
    # single mode, with and without --plot
    monkeypatch.chdir(os.path.join(root, "port"))
    capsys.readouterr()
    for main, pkg in ((j_check, "jax"), (p_check, "port")):
        argv = ["--scenario_path", os.path.join("gt", sid + ".xml"),
                "--solution_path", hit]
        (_jax(main.main, argv, monkeypatch) if pkg == "jax"
         else main.main(argv + ["--plot", "single.png"]))
        assert capsys.readouterr().out == "Does collision exist?  True\n"
    with open("single.png", "rb") as f:
        assert TK.decode_png_rgb(f.read()).shape == (600, 1000, 3)


def test_the_io_split_writes_the_same_files_with_either_io(tmp_path,
                                                          capsys):
    """cli/safety_io_split.py's four runs (the port's IO, ElementTree's,
    the port's without its bound cache, the port's) write the same bytes
    and metrics, or it exits."""
    root = str(tmp_path)
    chip_smoke.write_labeled_corpus(root, (
        ("static_label", None, 1), ("dynamic_label", "dynamic_annotation", 1),
        ("road_dynamic_label", "road_dynamic_annotation", 1)), SEED)
    runs = safety_io_split.main([
        "--input_folder", os.path.join(root, "kitti_labeled"),
        "--det_folder", os.path.join(root, "det"),
        "--work", os.path.join(root, "io")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["io"] for r in runs] == ["text", "etree", "text_uncached",
                                       "text"]
    assert line["safety_io_split"]["scenarios"] == 3
    assert line["safety_io_split"]["metrics"]["num_scenarios"] == 3
    assert all(set(r["stage_s"]) == {"convert_gt", "convert", "plan",
                                     "check", "eval"} for r in runs)
    assert os.listdir(os.path.join(root, "io")) == []


def test_plots_draw_obstacles_inside_the_jax_corners(tmp_path):
    rng = np.random.RandomState(0)
    for _ in range(50):
        args = (*rng.uniform(-20, 20, 2), *rng.uniform(0.5, 6, 2),
                rng.uniform(-4, 4))
        assert np.array_equal(PPLOT._rect_corners(*args),
                              JPLOT._rect_corners(*args))
    root = str(tmp_path)
    chip_smoke.write_labeled_corpus(root, COUNTS, SEED)
    p_convert.main(["--input_folder", os.path.join(root, "det"),
                    "--output_folder", os.path.join(root, "sc")])
    drawn = 0
    for name in sorted(os.listdir(os.path.join(root, "sc")))[:4]:
        path = os.path.join(root, "sc", name)
        png = os.path.join(root, name + ".png")
        p_plot_scenario.main(["--scenario_path", path, "--output", png])
        with open(png, "rb") as f:
            img = TK.decode_png_rgb(f.read())
        assert img.shape == (600, 1000, 3)
        color, alpha = PPLOT.STATIC
        fill = np.round((alpha * color + (1 - alpha)) * 255.0)
        ys, xs = np.nonzero((img == fill).all(-1))
        inside = np.zeros(len(xs), bool)
        sc = read_scenario(path)
        for ob in sc.static_obstacles:
            st = ob.initial_state
            q = PPLOT.to_pixels(JPLOT._rect_corners(
                st.position[0], st.position[1], ob.shape.length,
                ob.shape.width, st.orientation), (-10, 40), (-15, 15))
            inside |= _in_polygon(q, xs + 0.5, ys + 0.5)
        assert inside.all()
        drawn += len(xs)
    assert drawn > 500


def _in_polygon(q, u, v):
    """Pixel centers (u, v) inside the convex polygon q, grown by a
    pixel's half diagonal (a center on an edge may round either way)."""
    c = q.mean(0)
    grown = c + (q - c) * (1 + 0.75 / np.maximum(
        np.linalg.norm(q - c, axis=1, keepdims=True), 1e-9))
    a, b = grown, np.roll(grown, -1, axis=0)
    cross = ((b[:, 0] - a[:, 0])[:, None] * (v - a[:, 1, None])
             - (b[:, 1] - a[:, 1])[:, None] * (u - a[:, 0, None]))
    return (cross >= 0).all(0) | (cross <= 0).all(0)


CALIB = ("P2: 180.0 0.0 160.0 0.0 0.0 180.0 48.0 0.0 0.0 0.0 1.0 0.0\n"
         "P3: 180.0 0.0 160.0 -97.2 0.0 180.0 48.0 0.0 0.0 0.0 1.0 0.0\n")


def test_chain_from_the_ports_predict(tmp_path, monkeypatch, capsys):
    """The tiny DSGN predict on the CPU (class bias raised so it exports
    boxes) -> the port's convert, plan, check and eval, against the JAX
    safety CLIs on the same txts, with ground truth from phase 4's labels
    as a kitti_labeled tree (one static frame, one road-dynamic)."""
    root = str(tmp_path)
    data = os.path.join(root, "kitti")
    ids = ["000001", "000002"]
    rng = np.random.RandomState(0)
    for sub in ("image_2", "image_3", "calib", "label_2"):
        os.makedirs(os.path.join(data, sub))
    for fid in ids:
        left = rng.randint(0, 256, (96, 320, 3)).astype(np.uint8)
        TK.write_png(os.path.join(data, "image_2", fid + ".png"), left)
        TK.write_png(os.path.join(data, "image_3", fid + ".png"),
                     np.roll(left, -5, axis=1))
        with open(os.path.join(data, "calib", fid + ".txt"), "w") as f:
            f.write(CALIB)
        with open(os.path.join(data, "label_2", fid + ".txt"), "w") as f:
            f.write(chip_smoke.LABELS)
    labeled = os.path.join(root, "kitti_labeled")
    for sub, fid, codes in (("static_label", "000001", None),
                            ("road_dynamic_label", "000002", "1\n0\n")):
        os.makedirs(os.path.join(labeled, sub))
        with open(os.path.join(labeled, sub, fid + ".txt"), "w") as f:
            f.write(chip_smoke.LABELS)
        if codes:
            os.makedirs(os.path.join(labeled, "road_dynamic_annotation"))
            with open(os.path.join(labeled, "road_dynamic_annotation",
                                   fid + ".txt"), "w") as f:
                f.write(codes)
    model = DSGN(DSGNConfig.tiny()).init_weights(0)
    with torch.no_grad():
        model.BEVHead_0.cls.bias.fill_(1.0)
    torch.save(model.state_dict(), os.path.join(root, "w.pt"))
    predict_main(["--data_path", data, "--detector", "dsgn", "--scale",
                  "tiny", "--device", "cpu", "--ckpt",
                  os.path.join(root, "w.pt"), "--result_dir",
                  os.path.join(root, "res")])
    det = os.path.join(root, "res", "data")
    lines = []
    for fid in ids:
        with open(os.path.join(det, fid + ".txt")) as f:
            lines += f.read().splitlines()
    assert lines and all(len(ln.split()) == 16 for ln in lines)
    jax_out = _chain(JAX_CLIS, os.path.join(root, "jax"), det, labeled,
                     monkeypatch, capsys)
    port_out = _chain(PORT_CLIS, os.path.join(root, "port"), det, labeled,
                      monkeypatch, capsys)
    assert jax_out == port_out
    assert port_out[2]["num_scenarios"] == 2
    assert _tree(os.path.join(root, "jax")) == \
        _tree(os.path.join(root, "port"))
