"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports no JAX
(the card's machine has none), so it runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 with TF32 off. Tolerances: forward atol 1e-5 (the same f32
arithmetic, with FMA contraction), gradients atol 1e-4 (summed over the
planes in another order, dW/d inv/d off over the whole grid with
atomics).
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
@pytest.mark.parametrize("d,c,f", [(1, 8, 16), (2, 16, 8), (9, 32, 64),
                                   (17, 64, 32)])
def test_depth_tap_conv_kernels_match_plain(dev, d, c, f, relu):
    rng = np.random.RandomState(d)
    # H * W = 35 leaves a ragged 32-pixel tile
    x = (rng.randn(2, d, 5, 7, c) * 0.5).astype(np.float32)
    wk = (rng.randn(3, c, f) * 0.2).astype(np.float32)
    inv = (rng.randn(f) * 0.5 + 1.0).astype(np.float32)
    off = (rng.randn(f) * 0.2).astype(np.float32)
    k = [torch.from_numpy(a).to(dev).requires_grad_(True)
         for a in (x, wk, inv, off)]
    p = [torch.from_numpy(a).requires_grad_(True) for a in (x, wk, inv, off)]
    before = dict(_cuda.launches)
    got = depth_tap_conv(*k, relu=relu)
    want = reference_depth_tap_conv(*p, relu=relu)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    g = torch.randn(want.shape)
    for a, b in zip(_grads(got, k, g.to(dev)), _grads(want, p, g)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    assert _cuda.launches["depth_tap_conv_fwd"] == \
        before["depth_tap_conv_fwd"] + 1
    # the full backward launches two kernels: dx, then dW / d inv / d off
    assert _cuda.launches["depth_tap_conv_bwd"] == \
        before["depth_tap_conv_bwd"] + 2
    assert _cuda.launch_shapes[("depth_tap_conv_bwd", (2, d, 35, c, f),
                                "float32")] >= 2


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 12, device=dev)
    with pytest.raises(ValueError):          # C = 12 is not a tile width
        depth_tap_conv(x, torch.zeros(3, 12, 12, device=dev),
                       torch.ones(12, device=dev), torch.zeros(12, device=dev))
    with pytest.raises(TypeError):           # float16 is not compiled
        psv_warp(torch.zeros(1, 2, 8, 4, device=dev, dtype=torch.float16),
                 torch.zeros(1, 3, device=dev))
