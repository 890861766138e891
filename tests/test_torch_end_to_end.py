"""The port's full-story run (eval_driving_safety_tpu_torch/examples/
end_to_end_demo.py) against the JAX package's examples/end_to_end_demo.py,
on the CPU at DSGNConfig.tiny() in fp32: the scene bit for bit (taken
from the JAX script itself), three Adam steps and the 8-iteration PGD on
the same bridged weights, the safety half on fixed boxes exactly, and a
short run. One test runs the story on the card (`-m cuda`) and holds it
to tests/test_dsgn_end_to_end.py's conditions.

JAX is imported inside fixtures, so that the card's machine, which has
none, can run the card test with

    python -m pytest --noconftest -m cuda tests/test_torch_end_to_end.py

Tolerances: tests/test_torch_train.py's for the Adam steps (losses
within 1e-5 relative, gradients within 1e-4 x the largest, the
parameters within 1e-6 of optax's on the same gradients; see
test_three_adam_steps_match_optax); the PGD losses within 1e-5 relative,
its input gradients within 1e-3 x the largest, and the views equal but
where a gradient within that of 0 takes the other sign (see
test_demo_pgd_matches_jax_pgd_attack); the safety metrics exactly.
"""
import contextlib
import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.examples import end_to_end_demo as D
from eval_driving_safety_tpu_torch.models.dsgn import DSGN

DEMO = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
    "end_to_end_demo.py"
SCENE_END = "# 2. overfit the detector"
SAFETY_START = "# 4. safety impact"
SAFETY_END = "m_clean = safety("
METRICS_KEYS = {"clean", "adv", "clean_score", "clean_err", "adv_score",
                "attack_ascent"}
FP32 = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
# input gradients of the PGD at JAX's iterates, x the largest
PGD_GTOL = 1e-3


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX script's namespace after its scene (section 1) and its
    safety definitions (section 4), run from its own source; the
    training and the attack between them are not run."""
    src = DEMO.read_text()
    ns = {"__file__": str(DEMO), "__name__": "jax_end_to_end_demo"}
    exec(compile(src[: src.index(SCENE_END)], str(DEMO), "exec"), ns)
    safety = src[src.index(SAFETY_START): src.index(SAFETY_END)]
    safety = safety[safety.index("\n") + 1:]
    exec(compile(safety, str(DEMO), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def bridged(jax_demo):
    """The JAX script's DSGN in fp32, initialised as the script does (key
    0 on the normalized scene), and the port's model on the same weights
    with the port's tiny scene."""
    import jax
    from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        dsgn_state_dict_from_flax
    ns = jax_demo
    jcfg = dataclasses.replace(ns["cfg"], dtype="float32")
    jm = JaxDSGN(jcfg)
    mean, std = ns["mean"], ns["std"]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              (ns["im_l"] - mean) / std,
                              (ns["im_r"] - mean) / std, *ns["calib_vec"])
    params = jax.tree_util.tree_map(np.asarray, params)
    scene = D.make_scene(FP32, D.scale_setup("tiny")[1])
    return jm, jcfg, params, dsgn_state_dict_from_flax(params), scene


def _port_model(state_dict):
    model = DSGN(FP32)
    model.load_state_dict(state_dict)
    return model


def _jax_loss(jm, jcfg, ns):
    from eval_driving_safety_tpu.models.rpn3d_loss import dsgn_total_loss
    mean, std = ns["mean"], ns["std"]

    def loss_fn(p, il01, ir01):
        out = jm.apply(p, (il01 - mean) / std, (ir01 - mean) / std,
                       *ns["calib_vec"])
        return dsgn_total_loss(out, ns["depth_gt"], ns["boxes3d"],
                               ns["num_boxes"], jcfg)[0]
    return loss_fn


def test_scene_is_the_jax_demos_bit_for_bit(jax_demo):
    ns = jax_demo
    scene = D.make_scene(*D.scale_setup("tiny"))
    want = {"left": ns["im_l"], "right": ns["im_r"],
            "boxes3d": ns["boxes3d"], "num_boxes": ns["num_boxes"],
            "depth": ns["depth_gt"]}
    for name, w in want.items():
        got = getattr(scene, name).numpy()
        w = np.asarray(w)
        assert got.shape == w.shape and np.array_equal(got, w), name
    for got, w in zip(scene.calib, ns["calib_vec"]):
        assert np.array_equal(got.numpy(), np.asarray(w, np.float32))
    # the views hold the car where the script paints it: textured (>= 0.4)
    # on the noise field (< 0.3)
    assert (scene.left.numpy() >= 0.4).mean() > 0.05


def _grad_errors(grads, jgrads):
    """Each leaf's largest gradient error over the leaf's largest JAX
    gradient; a Score3D bias, whose gradient the soft-argmin cancels
    (rounding noise on both sides), over its layer's weight's, as
    tests/test_torch_train.py holds them."""
    worst = {}
    for name, g in grads.items():
        ref = name.replace(".bias", ".weight") \
            if name.startswith("depth_score") else name
        scale = float(np.abs(jgrads[ref]).max())
        worst[name] = float(np.abs(g - jgrads[name]).max()) / scale
    return worst


def test_three_adam_steps_match_optax(jax_demo, bridged):
    """Three steps of the script's optax.adam(2e-3) from the bridged
    weights. `overfit(model, scene, 3)` gives its losses at steps 0 and 2
    within 1e-5 relative. The parameters are held step by step within
    test_torch_train's tolerances: every gradient at the bridged weights
    (1e-4 x the largest), the port's loss at each step's weights (1e-5
    relative), and `optimizer`, overfit's Adam, stepped on JAX's
    gradients, the parameters within 1e-6 of optax's. On each side's own
    gradients the parameters drift further apart: Adam moves an element
    by about lr whatever its gradient's size, so a gradient of rounding
    size (the Score3D biases', which the soft-argmin cancels) moves it by
    up to lr either way, and the gradients of the next steps are no
    longer those of the same weights. Past the first step the gradients
    are held through the losses only: a ReLU input within rounding of 0
    at the trained weights moves a FrozenBatchNorm gradient by up to
    8e-4 of its largest on the CPU."""
    import jax
    import optax
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        dsgn_state_dict_from_flax
    jm, jcfg, params, sd, scene = bridged
    loss_fn = _jax_loss(jm, jcfg, jax_demo)
    tx = optax.adam(2e-3)

    @jax.jit
    def train_step(p, o):
        total, grads = jax.value_and_grad(loss_fn)(p, jax_demo["im_l"],
                                                    jax_demo["im_r"])
        updates, o = tx.update(grads, o)
        return optax.apply_updates(p, updates), o, total, grads

    as_sd = lambda tree: {k: v.numpy() for k, v in dsgn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    p, o, want = params, tx.init(params), []
    for _ in range(3):
        p, o, total, grads = train_step(p, o)
        want.append((float(total), as_sd(grads), as_sd(p)))

    got = D.overfit(_port_model(sd), scene, 3)
    assert sorted(got) == [0, 2]
    np.testing.assert_allclose([got[0], got[2]], [want[0][0], want[2][0]],
                               rtol=1e-5)

    model = _port_model(sd)
    opt = D.optimizer(model)
    for step, (jtotal, jgrads, jparams) in enumerate(want):
        total = D.scene_loss(model, scene, scene.left, scene.right)
        opt.zero_grad()
        total.backward()
        np.testing.assert_allclose(float(total.detach()), jtotal, rtol=1e-5)
        if step == 0:
            grads = {k: q.grad.numpy() for k, q in model.named_parameters()}
            assert set(grads) == set(jgrads) and len(grads) == 177
            bad = {k: v for k, v in _grad_errors(grads, jgrads).items()
                   if v > 1e-4}
            assert not bad, f"gradients off: {bad}"
        for k, q in model.named_parameters():
            q.grad = torch.from_numpy(jgrads[k].copy())
        opt.step()
        for k, q in model.named_parameters():
            np.testing.assert_allclose(q.detach().numpy(), jparams[k],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    # every parameter moved, the FrozenBatchNorm statistics too
    assert all(not np.array_equal(jparams[k], sd[k].numpy())
               for k in jparams if k.endswith((".mean", ".var", "cls.weight")))


def test_demo_pgd_matches_jax_pgd_attack(jax_demo, bridged):
    """The demo's attack (8 iterations, alpha 2/255, eps 0.1, [0, 1]) on
    the bridged weights against the JAX package's pgd_attack with the
    script's arguments. At each of JAX's iterates the port's loss is
    within 1e-5 relative and its input gradients within 1e-3 x the
    largest: test_torch_train holds gradients to 1e-4 at random inputs,
    but an iterate can put a ReLU's input within rounding of 0, and the
    side each framework rounds it to moves every gradient downstream of
    it (by up to 4e-4 of the largest at the sixth iterate here). On its
    own iterates the port follows JAX's bit for bit, but where JAX's
    gradient at the last equal iterate is within that tolerance of 0,
    whose sign may go either way; its losses up to there within 1e-5
    relative. Past the first such pixel the two attacks are different
    attacks: a pixel 2 alpha apart moves the next gradients, and
    sign-PGD flips the pixels whose gradients are small (a quarter of
    them by the last iteration here)."""
    import jax
    from eval_driving_safety_tpu.attack.pgd import pgd_attack as jax_pgd
    from eval_driving_safety_tpu_torch.attack.pgd import pgd_attack
    jm, jcfg, params, sd, scene = bridged
    ns = jax_demo
    loss_fn = _jax_loss(jm, jcfg, ns)

    @jax.jit
    def run_attack(il01, ir01):
        return jax_pgd(lambda l, r: loss_fn(params, l, r), il01, ir01,
                       num_iters=8, alpha=2 / 255, eps=0.1, clip_min=0.0,
                       clip_max=1.0, collect=True)

    jax_grads = jax.jit(jax.value_and_grad(
        lambda l, r: loss_fn(params, l, r), argnums=(0, 1)))
    want = run_attack(ns["im_l"], ns["im_r"])
    jlosses = np.asarray(want.losses)
    jiters = [(ns["im_l"], ns["im_r"])] + [
        (want.trajectory[0][k], want.trajectory[1][k]) for k in range(7)]

    model = _port_model(sd).requires_grad_(False)
    got = D.attack(model, scene)
    run = pgd_attack(lambda l, r: D.scene_loss(model, scene, l, r),
                     scene.left, scene.right, clip_min=0.0, clip_max=1.0,
                     collect=True, **D.ATTACK)
    assert torch.equal(got.adv_left, run.adv_left) and torch.equal(
        got.adv_right, run.adv_right) and torch.equal(got.losses, run.losses)
    equal_to = 0                       # the port's iterates 0..equal_to
    for k, (jl, jr) in enumerate(jiters):
        vl = torch.tensor(np.asarray(jl), requires_grad=True)
        vr = torch.tensor(np.asarray(jr), requires_grad=True)
        loss = D.scene_loss(model, scene, vl, vr)
        grads = torch.autograd.grad(loss, (vl, vr))
        jloss, jg = jax_grads(jl, jr)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(jloss), jlosses[k], rtol=1e-6)
        same_next = True
        for side, (g, j) in enumerate(zip(grads, jg)):
            j = np.asarray(j)
            scale = float(np.abs(j).max())
            assert float(np.abs(g.numpy() - j).max()) <= PGD_GTOL * scale
            if equal_to == k and k < 7:
                differ = run.trajectory[side][k].numpy() != np.asarray(
                    want.trajectory[side][k])
                assert (np.abs(j[differ]) <= PGD_GTOL * scale).all(), (k, side)
                same_next &= not differ.any()
        if equal_to == k and k < 7 and same_next:
            equal_to = k + 1
    np.testing.assert_allclose(run.losses.numpy()[: equal_to + 1],
                               jlosses[: equal_to + 1], rtol=1e-5)
    assert equal_to >= 1 and run.losses[-1] > run.losses[0]
    for adv, clean in ((got.adv_left, scene.left),
                       (got.adv_right, scene.right)):
        step = (adv - clean).abs()
        assert float(step.max()) <= 8 * 2 / 255 + 1e-6
        assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0


BOXES = {
    # the clean detection of a trained detector: on the car
    "on_the_car": [0.3, 1.6, 10.4, 1.5, 1.7, 4.0, 0.05],
    # a displaced detection: off the ego's path
    "off_the_path": [6.0, 1.6, 10.0, 1.5, 1.7, 4.0, 0.0],
    # no detection
    "none": None,
}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_safety_half_matches_jax(jax_demo, case):
    """The script's `safety` (its ground truth built from a clean
    detection on the car) against the port's `safety` with
    `true_scenario`, on the detection `case`: the same {"success",
    "collision"}."""
    ns = jax_demo
    clean = dict(box=np.asarray(BOXES["on_the_car"], np.float32))
    det = None if BOXES[case] is None else dict(
        box=np.asarray(BOXES[case], np.float32))
    ns["clean"] = clean
    with contextlib.redirect_stdout(io.StringIO()):
        want = ns["safety"](case, ns["to_objects"](det) if det else [])
        got = D.safety(case, D.to_objects(det), D.true_scenario(clean))
    assert got == want
    expect = {"on_the_car": {"success": 1, "collision": 0},
              "off_the_path": {"success": 1, "collision": 1},
              "none": {"success": 1, "collision": 1}}[case]
    assert got == expect


def test_short_run_returns_every_metrics_key():
    stats = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        m = D.run(scale="tiny", device="cpu", steps=2, stats=stats)
    assert set(m) == METRICS_KEYS
    for side in ("clean", "adv"):
        assert set(m[side]) == {"success", "collision"}
        assert all(v in (0, 1) for v in m[side].values())
    assert np.isfinite(m["attack_ascent"]) and m["adv_score"] >= 0.0
    assert json.loads(json.dumps(m)) == m
    assert stats["steps"] == 2 and sorted(stats["losses"]) == [0, 1]
    assert len(stats["attack_losses"]) == 8
    assert len(stats["weights_sha256"]) == 64
    assert "running PGD attack" in out.getvalue()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_tiny_story_flips_the_safety_metrics_on_the_card(card):
    """tests/test_dsgn_end_to_end.py's conditions on the port's story."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = D.main(["--scale", "tiny", "--device", card])
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines[-1] == "DONE", out.getvalue()[-2000:]
    m = json.loads([ln for ln in lines if ln.startswith("METRICS ")][-1]
                   [len("METRICS "):])
    assert m["clean_score"] >= 0.5 and m["clean_err"] < 3.0, m
    assert m["clean"]["success"] == 1 and m["clean"]["collision"] == 0, m
    assert m["attack_ascent"] > 0.0, m
    assert m["adv"]["collision"] == 1 or m["adv"]["success"] == 0, m
