"""The ported DSGN against the JAX reference on CPU: tiny config, fp32,
the same seeded inputs and the same (bridged) weights.

Tolerances: outputs rtol 1e-4 and losses rtol 1e-5, with an absolute
floor of 1e-4 x the largest reference magnitude for values near zero;
input gradients rtol 1e-3 with a floor of 1e-3 x the largest magnitude.
Both frameworks compute in fp32 but sum in different orders (convs,
einsums, softmax), which moves the last few bits of each output; the
gradient runs back through about forty layers and a softmax over the
planes, which amplifies those differences by about ten.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
from eval_driving_safety_tpu.models.rpn3d_loss import \
    dsgn_total_loss as jax_total_loss
from eval_driving_safety_tpu_torch.config import DSGNConfig
from eval_driving_safety_tpu_torch.models.dsgn import DSGN
from eval_driving_safety_tpu_torch.models.rpn3d_loss import (
    assign_bev_targets, dsgn_total_loss)
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

MEAN255 = np.asarray((0.485, 0.456, 0.406), np.float32) * 255.0
STD255 = np.asarray((0.229, 0.224, 0.225), np.float32) * 255.0

# (JAX psv_method, JAX depthconv_method): the JAX model's Pallas path and
# its library default compute the same function; the port has one path
# (its kernels, whose plain versions run here) and is held against both
VARIANTS = {
    "kernel": ("pallas", "pallas"),
    "library": ("einsum", "transpose"),
}


def _inputs():
    rng = np.random.RandomState(0)
    b, h, w = 1, 96, 320
    il = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    ir = np.roll(il, -6, axis=2) + rng.randint(-8, 9, il.shape)
    ir = np.clip(ir, 0, 255).astype(np.float32)
    calib = [np.full((b,), v, np.float32)
             for v in (180.0, 0.54, 160.0, 48.0)]
    depth = np.where(rng.rand(b, h, w) < 0.5,
                     rng.uniform(1.0, 70.0, (b, h, w)),
                     0.0).astype(np.float32)
    boxes = np.zeros((b, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    boxes[0, 1] = [-6.0, 1.5, 30.0, 1.6, 1.8, 3.8, -1.2, 1.0]
    nb = np.array([2], np.int32)
    return il, ir, calib, depth, boxes, nb


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """JAX reference results and the bridged port model for one variant."""
    jpsv, jdep = VARIANTS[request.param]
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32",
                               psv_method=jpsv, depthconv_method=jdep)
    tcfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    il, ir, calib, depth, boxes, nb = _inputs()
    jm = JaxDSGN(jcfg)

    def norm(x):
        return (x - MEAN255) / STD255

    params = jax.jit(jm.init)(jax.random.PRNGKey(1), norm(il), norm(ir),
                              *calib)

    def loss_fn(p, l255, r255):
        out = jm.apply(p, norm(l255), norm(r255), *calib)
        total, parts = jax_total_loss(out, depth, boxes, nb, jcfg)
        return total, (out, parts)

    (jtotal, (jout, jparts)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(1, 2), has_aux=True))(
        params, jnp.asarray(il), jnp.asarray(ir))
    model = DSGN(tcfg)
    model.load_state_dict(dsgn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    ref = dict(total=float(jtotal), out=jax.tree_util.tree_map(np.asarray,
                                                               jout),
               parts={k: float(v) for k, v in jparts.items()},
               grads=[np.asarray(g) for g in jgrads], params=params)
    return tcfg, model, ref


def _close(got, want, rtol, floor):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-12))


def _port_loss(tcfg, model, il, ir):
    _, _, calib, depth, boxes, nb = _inputs()
    m255, s255 = torch.from_numpy(MEAN255), torch.from_numpy(STD255)
    out = model((il - m255) / s255, (ir - m255) / s255,
                *[torch.from_numpy(c) for c in calib])
    total, parts = dsgn_total_loss(out, torch.from_numpy(depth),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(nb).long(), tcfg)
    return total, parts, out


def test_bridge_covers_every_parameter(pair):
    _, model, ref = pair
    sd = dsgn_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          ref["params"]))
    assert len(sd) == 177 and set(sd) == set(model.state_dict())
    tops = {}
    for k in sd:
        top = k.split(".")[0]
        tops[top] = tops.get(top, 0) + 1
    assert tops["StereoFeatureNet_0"] == 85
    assert tops["Hourglass3D_0"] == 42
    assert tops["BEVHead_0"] == 26
    count = lambda prefix: sum(v for k, v in tops.items()
                               if k.startswith(prefix))
    assert count("ConvBnRelu2p1D_") == 18 and count("depth_score") == 6


def test_outputs_and_loss_match_jax(pair):
    tcfg, model, ref = pair
    il, ir = _inputs()[:2]
    with torch.no_grad():
        total, parts, out = _port_loss(tcfg, model, torch.from_numpy(il),
                                       torch.from_numpy(ir))
    for got, want in zip(out["depth_preds"], ref["out"]["depth_preds"]):
        _close(got.numpy(), want, 1e-4, 1e-4)
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        _close(out[k].numpy(), ref["out"][k], 1e-4, 1e-4)
    for k, v in ref["parts"].items():
        _close(parts[k].numpy(), v, 1e-5, 1e-6)
    assert ref["parts"]["rpn3d_reg"] > 0       # positives were assigned


def test_input_gradient_matches_jax(pair):
    tcfg, model, ref = pair
    il, ir = (torch.from_numpy(a).requires_grad_(True)
              for a in _inputs()[:2])
    total, _, _ = _port_loss(tcfg, model, il, ir)
    gl, gr = torch.autograd.grad(total, (il, ir))
    _close(gl.numpy(), ref["grads"][0], 1e-3, 1e-3)
    _close(gr.numpy(), ref["grads"][1], 1e-3, 1e-3)


def test_bev_targets_match_jax():
    """Labels and the positive mask must be equal; regression targets
    within 1e-5 and centerness within 1e-6 (the cell-center grids come
    from each framework's own linspace, which may differ in the last
    bit)."""
    from eval_driving_safety_tpu.models.rpn3d_loss import \
        assign_bev_targets as jax_assign
    cfg = DSGNConfig.tiny()
    boxes, nb = _inputs()[4:]
    want = jax_assign(jnp.asarray(boxes), jnp.asarray(nb),
                      JaxDSGNConfig.tiny())
    got = assign_bev_targets(torch.from_numpy(boxes),
                             torch.from_numpy(nb).long(), cfg)
    assert np.array_equal(got.pos_mask.numpy(), np.asarray(want.pos_mask))
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.pos_mask.sum() > 0
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg),
                               atol=1e-5)
    np.testing.assert_allclose(got.centerness.numpy(),
                               np.asarray(want.centerness), atol=1e-6)


def test_objectives_match_jax(pair):
    """The three attack objectives on the same outputs: means over the
    depth maps, so rtol 1e-4 as for the outputs themselves."""
    from eval_driving_safety_tpu.attack import objectives as JO
    from eval_driving_safety_tpu_torch.attack import objectives as TO
    tcfg, model, ref = pair
    il, ir, calib, depth, boxes, nb = _inputs()
    with torch.no_grad():
        _, _, out = _port_loss(tcfg, model, torch.from_numpy(il),
                               torch.from_numpy(ir))
    jcfg = JaxDSGNConfig.tiny()
    d = torch.from_numpy(depth)
    pairs = [
        (TO.total_loss(out, d, torch.from_numpy(boxes),
                       torch.from_numpy(nb).long(), tcfg),
         JO.total_loss(ref["out"], depth, boxes, nb, jcfg)),
        (TO.depth_divergence(out, d, tcfg),
         JO.depth_divergence(ref["out"], depth, jcfg)),
        (TO.depth_shift(out, d, 10.0, tcfg),
         JO.depth_shift(ref["out"], depth, 10.0, jcfg)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("model_name", ["dsgn", "compat"])
def test_remat_gives_the_same_gradient(model_name):
    """cfg.remat recomputes the hourglass in the backward pass (the fast
    model's Hourglass3D_0, the compat model's hg1): the same arithmetic,
    so the input gradient is the same to the last bit up to the CPU's own
    summation order (rtol 1e-6)."""
    from eval_driving_safety_tpu_torch.models.dsgn_compat import (
        DSGNCompat, DSGNCompatArch)
    base = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = (DSGN(cfg) if model_name == "dsgn"
                 else DSGNCompat(cfg, DSGNCompatArch.tiny())).init_weights(5)
        il, ir = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs()[:2])
        total, _, _ = _port_loss(base, model, il, ir)
        grads.append(torch.autograd.grad(total, (il, ir)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("field,value", [("psv_method", "einsum"),
                                         ("depthconv_method", "transpose")])
def test_model_refuses_paths_without_the_kernels(field, value):
    """The JAX config's library paths have no counterpart in the port: a
    CUDA tensor goes through the kernels, so any other method is refused
    when the model is built."""
    cfg = dataclasses.replace(DSGNConfig.tiny(), **{field: value})
    with pytest.raises(ValueError, match=field):
        DSGN(cfg)
