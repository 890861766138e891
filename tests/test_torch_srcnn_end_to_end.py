"""The port's Stereo R-CNN full story (eval_driving_safety_tpu_torch/
examples/srcnn_end_to_end.py) against the JAX package's driver,
tests/srcnn_e2e_driver.py, on the CPU at StereoRCNNConfig.tiny() in
fp32: the scene bit for bit (taken from the driver's own source), three
steps of the clip + Adam chain and the 8-iteration PGD on the same
bridged weights with the draws JAX makes from its keys, the probe's
decode and the hit rule, and short runs. One test runs the story on the
card (`-m cuda`) and holds it to tests/test_srcnn_end_to_end.py's
conditions.

JAX is imported inside fixtures, so that the card's machine, which has
none, can run the card test with

    python -m pytest --noconftest -m cuda tests/test_torch_srcnn_end_to_end.py

Tolerances: tests/test_torch_srcnn_train.py's for the training steps
(the total loss within 1e-4 relative, each sampled parameter's gradient
within 1e-3 x its largest; see test_three_chain_steps_match_optax),
every parameter within 1e-6 of optax's when the port's chain steps on
JAX's gradients; the PGD losses within 1e-5 relative and its input
gradients within 5e-3 x the largest at JAX's iterates (see `PGD_GTOL`),
the views equal but where a gradient within that of 0 takes the other
sign (see test_pgd_matches_jax_pgd_attack); the decoded detections as
tests/test_torch_srcnn_predict.py holds them; the scene, the IoU and the
hit rule exactly.
"""
import contextlib
import io
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from eval_driving_safety_tpu_torch.config import StereoRCNNConfig
from eval_driving_safety_tpu_torch.examples import srcnn_end_to_end as S
from eval_driving_safety_tpu_torch.models.stereo_rcnn import StereoRCNN

DRIVER = pathlib.Path(__file__).resolve().parent / "srcnn_e2e_driver.py"
SCENE_START = "    cfg = StereoRCNNConfig.tiny()"
SCENE_END = "    model = StereoRCNN(cfg)"
DRIVER_KEYS = {"ok", "steps", "clean_score", "clean_iou", "attack_losses",
               "max_delta", "adv_score"}
TIME_KEYS = {"train_ms_per_step", "probe_ms", "wall_s"}
# sampled parameters whose gradients are held (tests/test_torch_srcnn_
# train.py's, and two FrozenBatchNorm statistics)
SAMPLED = ("backbone.stem_conv.weight", "backbone.stem_bn.mean",
           "backbone.layer1_block0.FrozenBatchNorm_0.var",
           "backbone.layer2_block0.Conv_1.weight", "fpn.smooth1.bias",
           "rpn.rpn_cls.bias", "rpn.rpn_box.weight", "rcnn.fc1.weight",
           "rcnn.cls_score.bias", "rcnn.bbox_pred.weight",
           "rcnn.dim_orien_pred.bias", "kpts.kpts_deconv.weight",
           "kpts.kpts_class.weight")
# input gradients at JAX's iterates, x the largest. The Stereo R-CNN
# attack tests hold them to 1e-3 at the init; three training steps widen
# the keypoint head's logits, whose f32 sum-order error then moves the
# keypoint loss by 8e-4 relative at the clean pair (the tests hold the
# keypoint softmaxes to 1e-3 for that reason), and the input gradient
# by up to 3.1e-3 of its largest, in the car's region (4.1e-4 at most at
# the other iterates). A thousandth of a pixel moves JAX's own gradient
# there by as much.
PGD_GTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this file runs (the suite runs several
    worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def driver():
    """The driver's namespace: its module level (imports, GT_BBOX, iou),
    then `main`'s scene, from `cfg = StereoRCNNConfig.tiny()` up to
    `model = StereoRCNN(cfg)`, dedented and run."""
    src = DRIVER.read_text()
    ns = {"__file__": str(DRIVER), "__name__": "srcnn_e2e_driver"}
    exec(compile(src[: src.index("def main():")], str(DRIVER), "exec"), ns)
    body = textwrap.dedent(src[src.index(SCENE_START):
                               src.index(SCENE_END)])
    exec(compile(body, str(DRIVER), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def jax_model(driver):
    """The driver's JAX model and variables (key 0, sampler key 1, attack
    mode), and its loss on a pair as a function of (state, left, right,
    draw key)."""
    import jax
    from eval_driving_safety_tpu.models.stereo_rcnn import total_attack_loss
    ns = driver
    model = ns["StereoRCNN"](ns["cfg"])
    variables = dict(jax.jit(lambda a, b: model.init(
        jax.random.PRNGKey(0), a, b, gt=ns["gt"], rng=jax.random.PRNGKey(1),
        mode="attack"))(ns["il"], ns["ir"]))
    constants = {k: v for k, v in variables.items() if k != "params"}

    def loss(state, left, right, key):
        out = model.apply({"params": state["params"], **constants}, left,
                          right, gt=ns["gt"], rng=key, mode="attack")
        return total_attack_loss(out.losses, state["uncert"])
    return model, variables, loss


def _draws(key):
    from test_torch_stereo_rcnn import jax_model_draws
    cfg = StereoRCNNConfig.tiny()
    n_anchors = StereoRCNN(cfg).anchors.shape[0]
    return jax_model_draws(key, 1, n_anchors,
                           cfg.post_nms_top_n + cfg.max_gt_boxes)


def _port(tree, uncert=None):
    """The port's tiny model on Flax weights, and `uncert` as a
    parameter."""
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        stereo_rcnn_state_dict_from_flax
    model = StereoRCNN(StereoRCNNConfig.tiny())
    model.load_state_dict(stereo_rcnn_state_dict_from_flax(tree, model))
    u = torch.zeros(6) if uncert is None else torch.tensor(
        np.asarray(uncert))
    return model, torch.nn.Parameter(u)


@pytest.fixture(scope="module")
def jax_steps(driver, jax_model):
    """Three steps of the driver's training step with its keys (split
    from key 2): each step's loss, raw gradients and global norm, and the
    state after it."""
    import jax
    import jax.numpy as jnp
    import optax
    ns = driver
    _, variables, loss = jax_model
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))

    @jax.jit
    def step(state, opt, r):
        tot, g = jax.value_and_grad(loss)(state, ns["il"], ns["ir"], r)
        up, opt = tx.update(g, opt, state)
        return optax.apply_updates(state, up), opt, tot, g, \
            optax.global_norm(g)

    state = {"params": variables["params"], "uncert": jnp.zeros((6,))}
    opt = tx.init(state)
    k = jax.random.PRNGKey(2)
    steps = []
    for _ in range(3):
        k, r = jax.random.split(k)
        state, opt, tot, g, norm = step(state, opt, r)
        steps.append({"key": r, "total": float(tot), "grads": g,
                      "norm": float(norm), "state": state})
    return steps


def test_scene_is_the_drivers_bit_for_bit(driver):
    ns = driver
    scene = S.make_scene("tiny")
    for got, want in ((scene.left, ns["il"]), (scene.right, ns["ir"])):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
    assert set(scene.gt) == set(ns["gt"])
    for k, want in ns["gt"].items():
        got, want = scene.gt[k].numpy(), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert np.array_equal(scene.box, ns["GT_BBOX"])
    assert np.array_equal(scene.calib.P2, ns["calib"].P2)
    assert np.array_equal(scene.calib.P3, ns["calib"].P3)
    # the car where the driver paints it: textured (>= 0.4 x 255 less the
    # means) inside the box, noise (< 0.3 x 255) on the rest of its rows
    pm = np.asarray(StereoRCNNConfig.tiny().input.pixel_means_bgr)
    raw = scene.left.numpy()[0] + pm
    assert (raw[40:70, 140:180] >= 0.4 * 255 - 1e-3).all()
    assert (raw[40:70, :140] < 0.3 * 255 + 1e-3).all()


def test_train_scene_projects_the_car():
    """The train scale: the car's box is its 3D box through the scaled
    KITTI camera, the texture covers it in the left view and the right
    view's copy sits the truncated disparity to its left."""
    cfg = StereoRCNNConfig()
    calib = S.train_calibration()
    assert calib.f_u == pytest.approx(721.5377 * 600 / 375)
    assert calib.baseline == pytest.approx(0.54)
    box = S.projected_box(calib)
    x1, y1, x2, y2 = (int(v) for v in box)
    # ry = pi/2: the car seen from behind, 1.7 m wide at 10-14 m
    assert 0 < x1 < x2 < cfg.input.width and 0 < y1 < y2 < cfg.input.height
    near = calib.f_u * 1.7 / 10.0
    assert near - 2 <= x2 - x1 <= near + 2
    scene = S.make_scene("train")
    assert scene.left.shape == (1, cfg.input.height, cfg.input.width, 3)
    disp = int(calib.f_u * 0.54 / 12.0)
    left, right = scene.left.numpy()[0], scene.right.numpy()[0]
    assert np.array_equal(left[y1:y2, x1:x2],
                          right[y1:y2, x1 - disp:x2 - disp])
    np.testing.assert_allclose(scene.gt["gt_left"][0, 0].numpy(),
                               [x1, y1, x2, y2, 1.0])
    np.testing.assert_allclose(
        scene.gt["gt_right"][0, 0, [0, 2]].numpy(),
        np.array([x1, x2]) - calib.f_u * 0.54 / 12.0, rtol=1e-6)


def test_three_chain_steps_match_optax(driver, jax_model, jax_steps):
    """The driver's optax.chain(clip_by_global_norm(10), adam(1e-3)) over
    the parameters and `uncert`, three steps from the bridged weights
    with JAX's draws. `overfit(model, uncert, scene, 3)` gives the first
    step's total within 1e-4 relative, the next two within 1e-2 (on its
    own gradients the port drifts, below), and the bits of a loop of
    `optimizer` on `scene_loss`. Step by step: the loss at each
    step's weights within 1e-4 relative, the first step's gradients
    (sampled parameters and `uncert`) within 1e-3 x their largest, and
    `optimizer`, overfit's chain, stepped on JAX's raw gradients (its
    clip included), every parameter within 1e-6 of optax's, the
    FrozenBatchNorm statistics too: they move, as JAX's Adam moves them.
    On its own gradients the port drifts further: Adam's first step
    moves an element by about lr whatever its gradient's size, so a
    gradient of rounding size moves it by up to lr either way."""
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        stereo_rcnn_state_dict_from_flax
    _, variables, _ = jax_model
    draws = [_draws(s["key"]) for s in jax_steps]
    scene = S.make_scene("tiny")

    model, uncert = _port(variables)
    got = S.overfit(model, uncert, scene, 3, draws=lambda i: draws[i],
                    probe_from=10, log=lambda m: None)
    assert got["probes"] == [] and got["best"] is None
    want = [s["total"] for s in jax_steps]
    np.testing.assert_allclose(got["losses"][0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got["losses"][1:], want[1:], rtol=1e-2)
    # overfit is the chain step for step: the same bits as a loop of
    # `optimizer` on `scene_loss`
    model, uncert = _port(variables)
    opt, mine = S.optimizer(model, uncert), []
    for i in range(3):
        total = S.scene_loss(model, uncert, scene, scene.left, scene.right,
                             draws[i])
        opt.zero_grad()
        total.backward()
        opt.step()
        mine.append(float(total.detach()))
    assert np.array_equal(got["losses"], np.asarray(mine, np.float32))

    model, uncert = _port(variables)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = S.optimizer(model, uncert)
    as_sd = lambda tree: {k: v.numpy() for k, v in
                          stereo_rcnn_state_dict_from_flax(tree,
                                                           model).items()}
    norms = []
    for i, want in enumerate(jax_steps):
        total = S.scene_loss(model, uncert, scene, scene.left, scene.right,
                             draws[i])
        opt.zero_grad()
        total.backward()
        np.testing.assert_allclose(float(total.detach()), want["total"],
                                   rtol=1e-4)
        jgrads = as_sd(want["grads"]["params"])
        juncert = np.asarray(want["grads"]["uncert"])
        params = dict(model.named_parameters())
        if i == 0:
            for name in SAMPLED:
                g = jgrads[name]
                assert np.abs(params[name].grad.numpy() - g).max() <= \
                    1e-3 * np.abs(g).max(), name
            assert np.abs(uncert.grad.numpy() - juncert).max() <= \
                1e-3 * np.abs(juncert).max()
        for name, p in params.items():
            p.grad = torch.from_numpy(jgrads[name].copy())
        uncert.grad = torch.from_numpy(juncert.copy())
        norms.append(float(torch.nn.utils.get_total_norm(
            [*(p.grad for p in params.values()), uncert.grad])))
        opt.step()
        after = as_sd(want["state"]["params"])
        assert set(after) == set(params)
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), after[name],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        np.testing.assert_allclose(uncert.detach().numpy(),
                                   np.asarray(want["state"]["uncert"]),
                                   rtol=0, atol=1e-6)
    # the global norm of ~1.7 M gradients, summed in another order
    np.testing.assert_allclose(norms, [s["norm"] for s in jax_steps],
                               rtol=1e-4)
    # the clip bound on at least one step
    assert max(norms) > 10.0, norms
    stats = [k for k in init if k.endswith((".mean", ".var"))]
    assert stats and all(not torch.equal(init[k], params[k].detach())
                         for k in stats)


def test_pgd_matches_jax_pgd_attack(driver, jax_model, jax_steps):
    """The story's attack (8 iterations, alpha 3, eps 76.5, the
    per-channel bounds, the draws of key 5 fixed) on the weights and
    `uncert` of the third training step, against the JAX package's
    pgd_attack with the driver's arguments. At each of JAX's iterates
    the port's loss is within 1e-5 relative and its input gradients
    within 5e-3 x the largest (`PGD_GTOL`). On its own iterates the port
    follows JAX's bit for bit, but where JAX's gradient at the last equal
    iterate is within that tolerance of 0, whose sign may go either way;
    its losses up to there within 1e-5 relative; at most 0.1% of the
    first step's pixels take such a sign. Past the first such pixel the
    two attacks are different attacks."""
    import jax
    import jax.numpy as jnp
    from eval_driving_safety_tpu.attack.pgd import pgd_attack as jax_pgd
    from eval_driving_safety_tpu.data.dataset import srcnn_clip_bounds
    ns = driver
    _, _, loss = jax_model
    state = jax_steps[-1]["state"]
    key = jax.random.PRNGKey(5)
    cmin, cmax = srcnn_clip_bounds(ns["cfg"].input)
    jloss = lambda l, r: loss(state, l, r, key)

    @jax.jit
    def run_attack(il, ir):
        return jax_pgd(jloss, il, ir, num_iters=8, alpha=3.0,
                       eps=255.0 * 0.3, clip_min=jnp.asarray(cmin),
                       clip_max=jnp.asarray(cmax), collect=True)

    jax_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))
    want = run_attack(ns["il"], ns["ir"])
    jlosses = np.asarray(want.losses)
    jiters = [(ns["il"], ns["ir"])] + [
        (want.trajectory[0][k], want.trajectory[1][k]) for k in range(7)]

    scene = S.make_scene("tiny")
    model, uncert = _port(state["params"], state["uncert"])
    model.requires_grad_(False)
    uncert = uncert.detach()
    draws = _draws(key)
    run = S.attack(model, uncert, scene, draws=draws, collect=True)
    equal_to = 0                       # the port's iterates 0..equal_to
    first_flips = 0
    for k, (jl, jr) in enumerate(jiters):
        vl = torch.tensor(np.asarray(jl), requires_grad=True)
        vr = torch.tensor(np.asarray(jr), requires_grad=True)
        got = S.scene_loss(model, uncert, scene, vl, vr, draws)
        grads = torch.autograd.grad(got, (vl, vr))
        jl_k, jg = jax_grads(jl, jr)
        np.testing.assert_allclose(float(got.detach()), float(jl_k),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(jl_k), jlosses[k], rtol=1e-6)
        same_next = True
        for side, (g, j) in enumerate(zip(grads, jg)):
            j = np.asarray(j)
            scale = float(np.abs(j).max())
            assert float(np.abs(g.numpy() - j).max()) <= PGD_GTOL * scale, \
                (k, side)
            if equal_to == k and k < 7:
                differ = run.trajectory[side][k].numpy() != np.asarray(
                    want.trajectory[side][k])
                assert (np.abs(j[differ]) <= PGD_GTOL * scale).all(), (k, side)
                same_next &= not differ.any()
                if k == 0:
                    first_flips += int(differ.sum())
        if equal_to == k and k < 7 and same_next:
            equal_to = k + 1
    np.testing.assert_allclose(run.losses.numpy()[: equal_to + 1],
                               jlosses[: equal_to + 1], rtol=1e-5)
    # the first step's signs differ at few pixels (25 of 2 x 92,160 here)
    assert first_flips <= 1e-3 * 2 * scene.left.numel(), first_flips
    # the default draws are key 5's generator's, fixed over the iterations
    again = S.attack(model, uncert, scene)
    assert torch.equal(again.losses, S.attack(model, uncert, scene).losses)
    for adv, clean in ((run.adv_left, scene.left),
                       (run.adv_right, scene.right)):
        assert float((adv - clean).abs().max()) <= 255.0 * 0.3
        assert (adv >= torch.from_numpy(cmin)).all() and (
            adv <= torch.from_numpy(cmax)).all()


@pytest.fixture(scope="module")
def planted(driver, jax_model):
    """The driver's JAX variables with planted heads, so that boxes reach
    the solver (tests/test_torch_srcnn_predict.py's planting): the Car
    bias raised over a kernel scaled by 0.01, zero box deltas but the
    right box's shift, a constant car from the dimension-orientation
    head, the RPN's box conv zeroed."""
    import flax
    import jax.numpy as jnp
    _, variables, _ = jax_model
    v = flax.core.unfreeze(variables)
    p = v["params"]
    rc = p["rcnn"]
    rc["cls_score"]["kernel"] = rc["cls_score"]["kernel"] * 0.01
    rc["cls_score"]["bias"] = jnp.asarray([0.0, 3.0])
    rc["bbox_pred"]["kernel"] = rc["bbox_pred"]["kernel"] * 0.0
    rc["bbox_pred"]["bias"] = jnp.asarray([0.0] * 10 + [-2.0, 0.0])
    rc["dim_orien_pred"]["kernel"] = rc["dim_orien_pred"]["kernel"] * 0.0
    rc["dim_orien_pred"]["bias"] = jnp.asarray(
        [0.0] * 5 + [1.5, 1.7, 4.0, 0.2, 0.98])
    p["rpn"]["rpn_box"]["kernel"] = p["rpn"]["rpn_box"]["kernel"] * 0.0
    return v


def test_detections_match_jax_predict_image(driver, jax_model, planted):
    """The probe on the planted weights: the port's `detections` (infer,
    one fetch, the decode without the alignment) against the JAX model's
    infer outputs through JAX's predict_image(..., dense_align=False),
    and the port's host outputs through JAX's decode; the hits the same
    under the driver's rule."""
    import jax
    from eval_driving_safety_tpu.inference.stereo_rcnn_predict import \
        predict_image as jax_predict
    from eval_driving_safety_tpu_torch.inference import \
        stereo_rcnn_predict as TP
    from test_torch_srcnn_predict import (_assert_same_detections,
                                          _with_batch_column)
    ns = driver
    jm, _, _ = jax_model
    cfg, H, W = ns["cfg"], ns["H"], ns["W"]
    jout = jax.jit(lambda a, b: jm.apply(planted, a, b, mode="infer"))(
        ns["il"], ns["ir"])
    want = jax_predict(jout, None, None, ns["calib"], cfg, image_hw=(H, W),
                       dense_align=False)
    scene = S.make_scene("tiny")
    model, _ = _port(planted)
    model.requires_grad_(False)
    got = S.detections(model, scene, scene.left, scene.right)
    _assert_same_detections(got, want)
    with torch.no_grad():
        host = TP.fetch_outputs(model(scene.left, scene.right, mode="infer"))
    _assert_same_detections(got, jax_predict(
        _with_batch_column(host), None, None, ns["calib"], cfg,
        image_hw=(H, W), dense_align=False))
    rule = lambda dets: [d for d in dets if d["type"] == "Car"
                         and ns["iou"](d["bbox"], ns["GT_BBOX"]) > 0.3]
    assert [d["score"] for d in S.hits(got, scene.box)] == \
        [d["score"] for d in rule(got)]
    assert len(S.hits(got, scene.box)) == len(rule(want))


BOXES = [
    [140.0, 40.0, 180.0, 70.0],        # the box itself
    [150.0, 45.0, 190.0, 75.0],
    [160.0, 40.0, 200.0, 70.0],        # IoU 1/3: a hit
    [163.0, 40.0, 203.0, 70.0],        # IoU 0.28: a miss
    [0.0, 0.0, 10.0, 10.0],            # disjoint
    [140.0, 40.0, 140.0, 70.0],        # zero width
    [139.5, 39.25, 180.75, 70.125],
    [100.0, 20.0, 300.0, 90.0],        # holds the box: IoU 0.086
]


def test_iou_and_hit_rule_are_the_drivers_exactly(driver):
    ns = driver
    gt = ns["GT_BBOX"]
    for b in BOXES:
        b = np.asarray(b)
        assert S.iou(b, gt) == ns["iou"](b, gt)
        assert S.iou(gt, b) == ns["iou"](gt, b)
    dets = [{"type": t, "bbox": np.asarray(b), "score": 0.1 * i}
            for i, (t, b) in enumerate(
                (t, b) for b in BOXES for t in ("Car", "Pedestrian"))]
    want = [d for d in dets if d["type"] == "Car"
            and ns["iou"](d["bbox"], gt) > 0.3]
    assert S.hits(dets, gt) == want
    assert [d["bbox"].tolist() for d in want] == BOXES[:3] + [BOXES[6]]


def test_short_run_gives_the_no_detection_line():
    with contextlib.redirect_stderr(io.StringIO()):
        got = S.run("tiny", steps=2, probe_from=1, probe_every=1,
                    device="cpu", log=lambda m: None)
    assert got["ok"] is False and got["why"] == "no detection"
    assert set(got) == {"ok", "why"} | TIME_KEYS
    assert got["train_ms_per_step"] > 0 and got["probe_ms"] > 0
    assert json.loads(json.dumps(got)) == got


def test_short_run_with_a_hit_gives_the_drivers_keys(monkeypatch, capsys):
    """A run whose probe finds the car (the decode stubbed to return the
    box as a Car): the driver's keys and the stage times, 8 ascending
    attack losses within eps; main prints the line last and exits 0."""
    real = S.detections
    calls = []

    def found(model, scene, left, right):
        calls.append(real(model, scene, left, right))
        return [{"type": "Car", "bbox": scene.box + 1.0, "score": 0.75}]
    monkeypatch.setattr(S, "detections", found)
    stats = {}
    got = S.run("tiny", steps=3, probe_from=2, probe_every=1, device="cpu",
                stats=stats, log=lambda m: None)
    assert set(got) == DRIVER_KEYS | TIME_KEYS | {"pgd_ms_per_iter"}
    assert got["ok"] and got["steps"] == 2 and got["clean_score"] == 0.75
    assert got["clean_iou"] == S.iou(S.make_scene("tiny").box + 1.0,
                                     S.TINY_BBOX)
    assert len(got["attack_losses"]) == 8
    assert got["attack_losses"][-1] > got["attack_losses"][0]
    assert 0 < got["max_delta"] <= 255.0 * 0.3
    assert got["adv_score"] == 0.75 and len(calls) == 2
    assert len(stats["losses"]) == 3 and stats["probes"] == [(2, 1)]
    assert np.isfinite(stats["losses"]).all()
    assert S.main(["--device", "cpu", "--steps", "2", "--probe_from", "2",
                   "--probe_every", "1"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["ok"] and line["steps"] == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the story's card run")
    return "cuda"


@pytest.mark.cuda
def test_tiny_story_finds_the_car_and_pgd_degrades_it_on_the_card(card):
    """tests/test_srcnn_end_to_end.py's conditions on the port's story."""
    out = S.run("tiny", device=card, log=lambda m: None)
    assert out["ok"], out
    assert out["clean_score"] >= 0.5
    assert out["clean_iou"] > 0.3
    losses = out["attack_losses"]
    assert losses[-1] > losses[0] + 10.0, losses
    assert out["max_delta"] <= 255.0 * 0.3 + 1e-3
    assert out["adv_score"] < out["clean_score"] - 0.1, out
