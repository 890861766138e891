"""The port's kernel modules and model blocks against the JAX reference
on CPU (the plain PyTorch versions; the CUDA kernels themselves are
checked on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py).

Tolerances: forward values atol 1e-5 and gradients atol 1e-4 (fp32; the
same arithmetic summed in other orders, with gradients summed over up to
eight planes); resizes 1e-6 (measured agreement is within 5e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import eval_driving_safety_tpu.ops.pallas_depthconv as jdtc
from eval_driving_safety_tpu.models.dsgn import \
    ConvBnRelu2p1D as JaxConvBnRelu2p1D
from eval_driving_safety_tpu.ops.cost_volume import \
    shift_along_width as jax_shift
from eval_driving_safety_tpu.ops.pallas_psv import (build_psv_pallas,
                                                    psv_warp as jax_psv_warp)
from eval_driving_safety_tpu_torch.models.common import (resize_bilinear,
                                                         resize_trilinear)
from eval_driving_safety_tpu_torch.models.dsgn import ConvBnRelu2p1D
from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.cost_volume import shift_along_width
from eval_driving_safety_tpu_torch.ops.depthconv import (_aligned,
                                                         depth_tap_conv)
from eval_driving_safety_tpu_torch.ops.psv_warp import build_psv, psv_warp
from eval_driving_safety_tpu_torch.utils.from_flax import \
    dsgn_state_dict_from_flax

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- (a) PSV

# H = 5 and 12 are not multiples of the TPU kernel's 8-row tile; the
# last disparities pass W - 1 (whole row masked) and 0 (no shift)
PSV_CASES = [
    ((5, 16, 4), [0.0, 0.25, 3.5, 7.999, 15.0, 15.5, 21.3]),
    ((12, 24, 8), [1.0, 2.75, 11.125, 23.0, 40.0]),
]


@pytest.mark.parametrize("shape,disps", PSV_CASES)
def test_psv_warp_matches_pallas_forward_and_grad(shape, disps):
    rng = np.random.RandomState(0)
    fr = rng.randn(*shape).astype(np.float32)
    d = np.asarray(disps, np.float32)
    g = rng.randn(len(disps), *shape).astype(np.float32)
    want = _np(jax_psv_warp(jnp.asarray(fr), jnp.asarray(d)))
    want_g = _np(jax.grad(lambda f: jnp.sum(jax_psv_warp(f, jnp.asarray(d))
                                            * g))(jnp.asarray(fr)))
    frt = T(fr)[None].requires_grad_(True)
    got = psv_warp(frt, T(d)[None])
    np.testing.assert_allclose(got[0].detach().numpy(), want, atol=1e-5)
    (got_g,) = torch.autograd.grad((got[0] * T(g)).sum(), frt)
    np.testing.assert_allclose(got_g[0].numpy(), want_g, atol=1e-4)


@pytest.mark.parametrize("disp", [0.0, 2.5, 7.75, 15.0, 19.0])
def test_shift_along_width_matches_jax(disp):
    # the port's plain warp takes a batch of planes; one plane of one
    # image is JAX's single-disparity shift
    fr = np.random.RandomState(1).randn(3, 16, 4).astype(np.float32)
    want = _np(jax_shift(jnp.asarray(fr), jnp.float32(disp)))
    got = shift_along_width(T(fr)[None], torch.tensor([[disp]]))[0, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_build_psv_matches_pallas_forward_and_grads():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 5, 24, 4
    fl = rng.randn(b, h, w, c).astype(np.float32)
    fr = rng.randn(b, h, w, c).astype(np.float32)
    fu = np.array([180.0, 150.0], np.float32)
    bl = np.array([0.54, 0.5], np.float32)
    planes = np.linspace(2.0, 59.6, 7).astype(np.float32)
    g = rng.randn(b, 7, h, w, 2 * c).astype(np.float32)

    def jf(a, r):
        return jnp.sum(build_psv_pallas(a, r, jnp.asarray(fu),
                                        jnp.asarray(bl), jnp.asarray(planes),
                                        4) * g)
    want = _np(build_psv_pallas(jnp.asarray(fl), jnp.asarray(fr),
                                jnp.asarray(fu), jnp.asarray(bl),
                                jnp.asarray(planes), 4))
    wgl, wgr = jax.grad(jf, argnums=(0, 1))(jnp.asarray(fl), jnp.asarray(fr))
    tl, tr = T(fl).requires_grad_(True), T(fr).requires_grad_(True)
    got = build_psv(tl, tr, T(fu), T(bl), T(planes), 4)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    gl, gr = torch.autograd.grad((got * T(g)).sum(), (tl, tr))
    np.testing.assert_allclose(gl.numpy(), _np(wgl), atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), _np(wgr), atol=1e-4)


# ---------------------------------------------------------- (b) depth conv

def _dtc_inputs(d, c, f, seed=0, hw=(4, 8)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, d, *hw, c) * 0.5).astype(np.float32)
    wk = (rng.randn(3, c, f) * 0.2).astype(np.float32)
    inv = (rng.randn(f) * 0.5 + 1.0).astype(np.float32)
    off = (rng.randn(f) * 0.2).astype(np.float32)
    g = rng.randn(2, d, *hw, f).astype(np.float32)
    return x, wk, inv, off, g


# (D, C, F, (H, W)) at B = 2: D of 1, 2, 6, and the fp32 kernels' edges,
# which the card checks hold against this plain version: D = 13 (runs of
# planes across blocks), C != F at widths 8-64, N = 136 and 72 ragged
# against their 128- and 64-pixel tiles (the TPU kernel takes N in
# multiples of 8)
DTC_CASES = [
    pytest.param(1, 8, 16, (4, 8), id="1"),
    pytest.param(2, 8, 16, (4, 8), id="2"),
    pytest.param(6, 8, 16, (4, 8), id="6"),
    pytest.param(13, 64, 32, (8, 17), id="13-c64-f32-n136"),
    pytest.param(13, 8, 16, (8, 9), id="13-c8-f16-n72"),
    pytest.param(3, 32, 64, (8, 9), id="3-c32-f64-n72"),
]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("d,c,f,hw", DTC_CASES)
def test_depth_tap_conv_matches_pallas(monkeypatch, d, c, f, hw, relu):
    # the JAX package runs its Pallas kernel in interpret mode off-TPU
    monkeypatch.setattr(jdtc, "_FORCE_INTERPRET", True)
    x, wk, inv, off, g = _dtc_inputs(d, c, f, seed=d, hw=hw)
    args = [jnp.asarray(a) for a in (x, wk, inv, off)]
    want = _np(jdtc.depth_tap_conv(*args, relu))
    want_g = jax.grad(lambda *a: jnp.sum(jdtc.depth_tap_conv(*a, relu) * g),
                      argnums=(0, 1, 2, 3))(*args)
    targs = [T(a).requires_grad_(True) for a in (x, wk, inv, off)]
    got = depth_tap_conv(*targs, relu=relu)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    got_g = torch.autograd.grad((got * T(g)).sum(), targs)
    for name, a, b in zip(("dx", "dW", "d inv", "d off"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth_tap_conv_copies_only_views_off_16_bytes(dtype):
    # the kernels copy 16-byte chunks: a view whose data starts off a
    # 16-byte boundary is copied once, counted; an aligned one is not
    _cuda.reset_launches()
    buf = torch.arange(1 + 2 * 3 * 8, dtype=torch.float32).to(dtype)
    aligned = buf[:48].view(2, 3, 8)
    assert aligned.data_ptr() % 16 == 0
    assert _aligned(aligned) is aligned and not _cuda.align_copies
    off = buf[1:].view(2, 3, 8)
    assert off.data_ptr() % 16 != 0
    got = _aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    assert _cuda.align_copies == {"depth_tap_conv": 1}
    _cuda.reset_launches()


# ------------------------------------------------- (c) resizes and blocks

@pytest.mark.parametrize("src,dst", [
    ((96, 312), (12, 39)), ((96, 312), (6, 19)), ((96, 312), (3, 9)),
    ((24, 80), (3, 10)), ((24, 80), (1, 5)), ((24, 80), (1, 2)),
    ((12, 39), (96, 312)), ((24, 80), (96, 320))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(3).randn(1, *src, 5).astype(np.float32)
    want = _np(jax.image.resize(x, (1, *dst, 5), "linear"))
    np.testing.assert_allclose(resize_bilinear(T(x), *dst).numpy(), want,
                               atol=1e-6)


@pytest.mark.parametrize("src,dst", [((19, 62), (38, 124)),
                                     ((38, 124), (75, 248))])
def test_resize_bilinear_fpn_upsamples_match_jax(src, dst):
    """The Stereo R-CNN FPN's top-down upsamples at 600 x 1984. 38 -> 75
    is no integer scale: each library computes its f32 weights its own
    way (a last-bit difference), so within 2e-6 of the largest
    magnitude."""
    x = np.random.RandomState(3).randn(1, *src, 5).astype(np.float32)
    want = _np(jax.image.resize(x, (1, *dst, 5), "linear"))
    np.testing.assert_allclose(resize_bilinear(T(x), *dst).numpy(), want,
                               rtol=0, atol=2e-6 * np.abs(want).max())


def test_resize_matrix_made_in_inference_mode_serves_autograd():
    """A resize first run under inference mode (predict) caches a matrix
    that a later resize with a gradient (an attack) can use."""
    with torch.inference_mode():
        resize_bilinear(torch.rand(1, 5, 7, 2), 10, 17)
    x = torch.rand(1, 5, 7, 2, requires_grad=True)
    (g,) = torch.autograd.grad(resize_bilinear(x, 10, 17).sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


@pytest.mark.parametrize("src,dst", [((3, 6, 20), (6, 12, 40)),
                                     ((5, 7, 9), (9, 13, 17))])
def test_resize_trilinear_matches_jax(src, dst):
    x = np.random.RandomState(4).randn(1, *src, 4).astype(np.float32)
    want = _np(jax.image.resize(x, (1, *dst, 4), "linear"))
    np.testing.assert_allclose(resize_trilinear(T(x), dst).numpy(), want,
                               atol=1e-6)


@pytest.mark.parametrize("stride,shape", [
    (2, (1, 6, 8, 10, 4)),     # even sizes: Flax pads (0, 1)
    (2, (1, 7, 9, 11, 4)),     # odd sizes: (1, 1)
    (1, (2, 5, 6, 8, 4))])
def test_conv_bn_relu_2p1d_matches_flax(stride, shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jm = JaxConvBnRelu2p1D(8, stride, depth_method="pallas")
    params = unfreeze(jm.init(jax.random.PRNGKey(stride), jnp.asarray(x)))
    # non-trivial BN statistics, so the folding is exercised
    bn = params["params"]["FrozenBatchNorm_0"]
    rng = np.random.RandomState(6)
    for k, lo in (("scale", 0.5), ("bias", -0.3), ("mean", -0.2),
                  ("var", 0.5)):
        bn[k] = jnp.asarray(lo + rng.rand(8).astype(np.float32))
    want = _np(jm.apply(params, jnp.asarray(x)))
    tm = ConvBnRelu2p1D(4, 8, stride)
    tm.load_state_dict(dsgn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(T(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------ wrappers: CPU or CUDA, nothing else

def test_wrappers_refuse_other_devices():
    fr = torch.empty(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError):
        psv_warp(fr, torch.zeros(1, 3, device="meta"))
    with pytest.raises(ValueError):
        depth_tap_conv(torch.empty(1, 2, 2, 2, 8, device="meta"),
                       torch.empty(3, 8, 8), torch.empty(8), torch.empty(8))


def test_launch_record_counts_kernel_launches_only():
    """`count_launch` adds one per launch to the kernel's count and to its
    (shape, dtype) entry, the dx kernel and the weight-gradient kernel
    each under its own name; the plain versions that serve CPU tensors
    add nothing, backward with weight gradients included; a name outside
    the record raises."""
    _cuda.reset_launches()
    assert set(_cuda.launches) == {
        "psv_warp_fwd", "psv_warp_bwd", "depth_tap_conv_fwd",
        "depth_tap_conv_bwd", "depth_tap_conv_wgrad"}
    args = [t.requires_grad_(True) for t in (
        torch.zeros(1, 2, 2, 2, 8), torch.zeros(3, 8, 8), torch.ones(8),
        torch.zeros(8))]
    depth_tap_conv(*args).sum().backward()
    psv_warp(torch.zeros(1, 2, 8, 4), torch.zeros(1, 3))
    assert sum(_cuda.launches.values()) == 0 and not _cuda.launch_shapes
    for _ in range(2):
        _cuda.count_launch("depth_tap_conv_bwd", (1, 2, 4, 8, 8),
                           torch.bfloat16)
    _cuda.count_launch("depth_tap_conv_wgrad", (1, 2, 4, 8, 8),
                       torch.bfloat16)
    assert _cuda.launches["depth_tap_conv_bwd"] == 2
    assert _cuda.launches["depth_tap_conv_wgrad"] == 1
    assert _cuda.launch_shapes == {
        ("depth_tap_conv_bwd", (1, 2, 4, 8, 8), "bfloat16"): 2,
        ("depth_tap_conv_wgrad", (1, 2, 4, 8, 8), "bfloat16"): 1}
    with pytest.raises(KeyError):
        _cuda.count_launch("depth_tap_conv_dw", (1,), torch.bfloat16)
    _cuda.reset_launches()
    assert sum(_cuda.launches.values()) == 0 and not _cuda.launch_shapes


def test_kernel_build_is_keyed_by_source_hash():
    paths = {n: _cuda.lib_path(n) for n in _cuda.SIGNATURES}
    assert set(paths) == {"psv_warp", "depth_tap_conv"}
    for name, p in paths.items():
        assert p.parent == _cuda.BUILD_DIR and p.name.startswith(name + "-")
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
