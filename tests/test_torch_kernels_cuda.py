"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports no JAX
(the card's machine has none), so it runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 with TF32 off. Tolerances: forward atol 1e-5 (the same f32
arithmetic, with FMA contraction), gradients atol 1e-4 (summed over the
planes in another order, dW/d inv/d off over the whole grid with
atomics). The depth-tap conv is also held in bf16, at 2^-7 x the largest
reference magnitude (one bf16 rounding step of either side).
"""
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.depthconv import (
    depth_tap_conv, reference_depth_tap_conv)
from eval_driving_safety_tpu_torch.ops.psv_warp import build_psv, psv_warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grads(out, inputs, g):
    return torch.autograd.grad((out * g).sum(), inputs)


@pytest.mark.parametrize("h,w,c", [(5, 24, 8), (12, 77, 16)])
def test_psv_kernels_match_plain(dev, h, w, c):
    rng = np.random.RandomState(h)
    fl_np, fr_np = (rng.randn(2, h, w, c).astype(np.float32)
                    for _ in range(2))
    fu = torch.tensor([180.0, 400.0])
    planes = torch.linspace(2.0, 59.6, 9)
    args = (fu, fu * 0 + 0.54, planes, 4)
    k = [torch.from_numpy(a).to(dev).requires_grad_(True)
         for a in (fl_np, fr_np)]
    p = [torch.from_numpy(a).requires_grad_(True) for a in (fl_np, fr_np)]
    got = build_psv(*k, *(a.to(dev) if torch.is_tensor(a) else a
                          for a in args))
    want = build_psv(*p, *args)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    g = torch.randn(want.shape)
    for a, b in zip(_grads(got, k, g.to(dev)), _grads(want, p, g)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    # the unfused warp takes disparities past W - 1
    disps = torch.tensor([[0.0, 3.25, w - 1.0, w + 4.5]])
    torch.testing.assert_close(
        psv_warp(k[1][:1].detach(), disps.to(dev)).cpu(),
        psv_warp(p[1][:1].detach(), disps), atol=1e-5, rtol=0)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,hw,c,f", [
    (1, (5, 7), 8, 16), (2, (5, 7), 16, 8), (9, (5, 7), 32, 64),
    (17, (5, 7), 64, 32),
    # bf16 tile edges: 65 pixels = one 64-pixel tile + 1; D = 3; D = 13
    # splits into chunks of 4 planes (3 at width 64), the last of one
    (3, (5, 13), 32, 64), (13, (5, 13), 64, 32), (13, (5, 7), 8, 16),
    (5, (5, 13), 64, 64), (2, (1, 1), 32, 32)])
def test_depth_tap_conv_kernels_match_plain(dev, d, hw, c, f, dtype, relu):
    rng = np.random.RandomState(d)
    dt = getattr(torch, dtype)
    x = (rng.randn(2, d, *hw, c) * 0.5).astype(np.float32)
    wk = (rng.randn(3, c, f) * 0.2).astype(np.float32)
    inv = (rng.randn(f) * 0.5 + 1.0).astype(np.float32)
    off = (rng.randn(f) * 0.2).astype(np.float32)
    k = [torch.from_numpy(a).to(dev, dt).requires_grad_(True)
         for a in (x, wk, inv, off)]
    p = [torch.from_numpy(a).to(dt).requires_grad_(True)
         for a in (x, wk, inv, off)]
    before = dict(_cuda.launches)
    got = depth_tap_conv(*k, relu=relu)
    want = reference_depth_tap_conv(*p, relu=relu)
    g = torch.randn(want.shape).to(dt)
    n = hw[0] * hw[1]
    if dtype == "float32":
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        pairs = zip(_grads(got, k, g.to(dev)), _grads(want, p, g))
    else:
        # bf16: one rounding step of either side, 2^-7 x the largest
        # magnitude; the backward is held against the plain VJP under the
        # kernel's own ReLU mask (pre-activations within rounding of 0
        # may take other signs in the two forwards)
        scale = float(want.detach().float().abs().max())
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=2.0 ** -7 * scale, rtol=0)
        gm = g * (got.detach().cpu() > 0) if relu else g
        q = [t.detach().clone().requires_grad_(True) for t in p]
        want_lin = reference_depth_tap_conv(*q, relu=False)
        pairs = zip(_grads(got, k, g.to(dev)), _grads(want_lin, q, gm))
    for a, b in pairs:
        atol = 1e-4 if dtype == "float32" else \
            2.0 ** -7 * float(b.float().abs().max())
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=atol,
                                   rtol=0)
    assert _cuda.launches["depth_tap_conv_fwd"] == \
        before["depth_tap_conv_fwd"] + 1
    # the full backward launches two kernels: dx, then dW / d inv / d off
    assert _cuda.launches["depth_tap_conv_bwd"] == \
        before["depth_tap_conv_bwd"] + 2
    assert _cuda.launch_shapes[("depth_tap_conv_bwd", (2, d, n, c, f),
                                dtype)] >= 2


def _offset_view(t, requires_grad=False):
    """A copy of `t` as a view one element past an aligned allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf.requires_grad_(requires_grad)[1:].view(t.shape)


@pytest.mark.parametrize("relu", [True, False])
def test_depth_tap_conv_bf16_copies_misaligned_views(dev, relu):
    # the bf16 kernels copy 16-byte chunks: x, w and dy given as views
    # that start 2 bytes off a 16-byte boundary are each copied once,
    # counted, and give the results of aligned inputs bit for bit
    rng = np.random.RandomState(4)
    bf = torch.bfloat16
    x, dy = (torch.from_numpy(rng.randn(2, 5, 5, 13, 32).astype(np.float32))
             .to(dev, bf) for _ in range(2))
    wk = torch.from_numpy((rng.randn(3, 32, 32) * 0.2).astype(np.float32))
    wk = wk.to(dev, bf)
    inv = torch.from_numpy((rng.randn(32) * 0.5 + 1.0).astype(np.float32))
    off = torch.from_numpy((rng.randn(32) * 0.2).astype(np.float32))
    inv, off = inv.to(dev, bf), off.to(dev, bf)
    xa = x.clone().requires_grad_(True)
    ya = depth_tap_conv(xa, wk, inv, off, relu=relu)
    (dxa,) = torch.autograd.grad(ya, xa, dy)
    xm, wm, dym = _offset_view(x, True), _offset_view(wk), _offset_view(dy)
    assert all(t.data_ptr() % 16 for t in (xm, wm, dym))
    before = _cuda.align_copies["depth_tap_conv"]
    ym = depth_tap_conv(xm, wm, inv, off, relu=relu)
    (dxm,) = torch.autograd.grad(ym, xm, dym)
    assert _cuda.align_copies["depth_tap_conv"] == before + 3
    assert torch.equal(ym, ya) and torch.equal(dxm, dxa)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 12, device=dev)
    with pytest.raises(ValueError):          # C = 12 is not a tile width
        depth_tap_conv(x, torch.zeros(3, 12, 12, device=dev),
                       torch.ones(12, device=dev), torch.zeros(12, device=dev))
    with pytest.raises(TypeError):           # float16 is not compiled
        psv_warp(torch.zeros(1, 2, 8, 4, device=dev, dtype=torch.float16),
                 torch.zeros(1, 3, device=dev))
