"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports no JAX
(the card's machine has none), so it runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 with TF32 off. Tolerances: forward atol 1e-5 (the same f32
arithmetic, with FMA contraction), gradients atol 1e-4 (summed over the
planes in another order, fp32 dW/d inv/d off over the whole grid); the
fp32 depth-tap conv forward and dx at their tiles' edges within 1e-5 x
the largest magnitude, bit for bit from call to call. The depth-tap
conv and the PSV warp are also held in bf16, at 2^-7 x the largest
reference magnitude (one bf16 rounding step of either side). The
weight gradient is held in both dtypes against its plain G-form
version (fp32 within 1e-4 x the largest magnitude: sums over the whole
grid in another order) and bit for bit from call to call.
"""
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.depthconv import (
    depth_tap_conv, reference_depth_tap_conv, reference_depth_tap_conv_wgrad,
    wgrad_geometry, wgrad_workspace_bytes)
from eval_driving_safety_tpu_torch.ops.cost_volume import shift_along_width
from eval_driving_safety_tpu_torch.ops.psv_warp import (build_psv,
                                                        psv_from_disparities,
                                                        psv_warp)

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


def _edge_disparities(b, w):
    """Other disparities per image: none, whole, W - 1, past the row,
    negative and fractional ones."""
    rows = [[0.0, 3.0, w - 1.0, w + 4.5, -0.5, 2.25, 17.6],
            [1.5, 0.0, 5.0, w - 1.0, 40.25, -0.5, 0.75]]
    return torch.tensor(rows[:b])


def _assert_close(got, want, dtype, atol32):
    atol = atol32 if dtype == "float32" else \
        2.0 ** -7 * float(want.detach().float().abs().max())
    torch.testing.assert_close(got.detach().cpu().float(),
                               want.detach().float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", [
    # C = 4, 8, 12, 32, 64: 8- and 16-byte accesses; W = 77 and 131 are
    # ragged against every backward tile; W = 1000 is a long row
    (1, 3, 77, 4), (2, 5, 77, 8), (1, 4, 100, 12), (2, 3, 77, 32),
    (1, 2, 131, 64), (1, 1, 1000, 64)])
def test_psv_kernels_at_their_edges(dev, b, h, w, c, dtype):
    rng = np.random.RandomState(c)
    dt = getattr(torch, dtype)
    fl_np, fr_np = (rng.randn(b, h, w, c).astype(np.float32)
                    for _ in range(2))
    disps = _edge_disparities(b, w)
    g = torch.from_numpy(rng.randn(b, disps.shape[1], h, w, 2 * c)
                         .astype(np.float32)).to(dt)
    k = [torch.from_numpy(a).to(dev, dt).requires_grad_(True)
         for a in (fl_np, fr_np)]
    p = [torch.from_numpy(a).to(dt).requires_grad_(True)
         for a in (fl_np, fr_np)]
    _cuda.reset_launches()
    got = psv_from_disparities(*k, disps.to(dev))
    want = psv_from_disparities(*p, disps)
    _assert_close(got, want, dtype, 1e-5)
    for a, r in zip(_grads(got, k, g.to(dev)), _grads(want, p, g)):
        _assert_close(a, r, dtype, 1e-4)
    # the unfused warp
    got_u = psv_warp(k[1], disps.to(dev))
    want_u = shift_along_width(p[1], disps)
    _assert_close(got_u, want_u, dtype, 1e-5)
    (a,) = _grads(got_u, [k[1]], g[..., c:].to(dev))
    (r,) = _grads(want_u, [p[1]], g[..., c:])
    _assert_close(a, r, dtype, 1e-4)
    width = 16 if c * k[0].element_size() % 16 == 0 else 8
    assert set(_cuda.launch_widths) == {("psv_warp_fwd", width),
                                        ("psv_warp_bwd", width)}
    assert not _cuda.align_copies


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psv_views_give_the_aligned_result_bit_for_bit(dev, dtype):
    # fl, fr and the gradient as views 1 element off a 16-byte boundary
    # take a narrower access, no copy; a non-contiguous gradient is copied
    # once, counted; the results equal those of aligned inputs bit for bit
    rng = np.random.RandomState(6)
    dt = getattr(torch, dtype)
    disps = _edge_disparities(1, 77).to(dev)
    fl, fr = (torch.from_numpy(rng.randn(1, 3, 77, 32).astype(np.float32))
              .to(dev, dt) for _ in range(2))
    g = torch.from_numpy(rng.randn(1, 7, 3, 77, 64).astype(np.float32))
    g = g.to(dev, dt)

    def run(a, r, grad):
        a, r = (t.detach().requires_grad_(True) for t in (a, r))
        out = psv_from_disparities(a, r, disps)
        return (out, *torch.autograd.grad(out, (a, r), grad))

    _cuda.reset_launches()
    want = run(fl, fr, g)
    _cuda.reset_launches()
    got = run(_offset_view(fl), _offset_view(fr), _offset_view(g))
    assert all(w < 16 for _, w in _cuda.launch_widths)
    assert not _cuda.align_copies
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    nc = torch.empty(1, 7, 3, 64, 77, dtype=dt, device=dev).transpose(-1, -2)
    got = run(fl, fr, nc.copy_(g))
    assert _cuda.align_copies == {"psv_warp": 1}
    assert all(torch.equal(x, y) for x, y in zip(got, want))


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
        before["depth_tap_conv_bwd"] + 1
    assert _cuda.launches["depth_tap_conv_wgrad"] == \
        before["depth_tap_conv_wgrad"] + 1
    for kernel in ("depth_tap_conv_bwd", "depth_tap_conv_wgrad"):
        assert _cuda.launch_shapes[(kernel, (2, d, n, c, f), dtype)] >= 1


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("b,d,n,c,f", [
    # the fp32 kernels' edges: N one past their 128-pixel tile (output
    # widths up to 32) or 64-pixel tile (64); D of 1, 2, 3, 13; C != F;
    # B = 2; runs of planes that cross tiles (D = 40 over 21 tiles) and
    # D = 1 over more tiles than one wave of blocks
    (1, 1, 129, 32, 32), (2, 2, 65, 64, 64), (1, 3, 129, 16, 8),
    (1, 13, 65, 64, 32), (2, 13, 129, 8, 16), (1, 5, 257, 32, 64),
    (1, 2, 1, 8, 8), (2, 40, 2561, 32, 32), (1, 1, 60000, 32, 32)])
def test_depth_tap_conv_fp32_edges_bit_for_bit(dev, b, d, n, c, f, relu):
    # forward and dx within 1e-5 x the plain version's largest magnitude
    # (dx against the plain VJP under the kernel's own ReLU mask), and two
    # calls give the same bits
    rng = np.random.RandomState(n + d)
    x = torch.from_numpy((rng.randn(b, d, n, 1, c) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, c, f) / c ** 0.5).astype(np.float32))
    inv = torch.from_numpy((rng.randn(f) * 0.2 + 1.0).astype(np.float32))
    off = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32))
    dy = torch.from_numpy(rng.randn(b, d, n, 1, f).astype(np.float32))
    xk = x.to(dev).requires_grad_(True)
    args = [t.to(dev) for t in (w, inv, off)]
    y = depth_tap_conv(xk, *args, relu=relu)
    (dx,) = torch.autograd.grad(y, xk, dy.to(dev), retain_graph=True)
    (dx2,) = torch.autograd.grad(y, xk, dy.to(dev))
    y2 = depth_tap_conv(xk.detach(), *args, relu=relu)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)
    xp = x.clone().requires_grad_(True)
    want = reference_depth_tap_conv(xp, w, inv, off, relu=relu)
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(y.detach().cpu(), want.detach(),
                               atol=1e-5 * scale, rtol=0)
    gm = dy * (y.detach().cpu() > 0) if relu else dy
    lin = reference_depth_tap_conv(xp, w, inv, off, relu=False)
    (want_dx,) = torch.autograd.grad(lin, xp, gm)
    torch.testing.assert_close(dx.cpu(), want_dx,
                               atol=1e-5 * float(want_dx.abs().max()), rtol=0)


@pytest.mark.parametrize("needs", ["x", "weights", "all"])
def test_depth_tap_backward_launches_what_autograd_asks_for(dev, needs):
    # dx alone (the attack) launches no weight-gradient kernel; weights
    # alone no dx kernel; both, one of each
    rng = np.random.RandomState(8)
    ts = [torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
          for a in (rng.randn(1, 5, 3, 7, 32), rng.randn(3, 32, 32) * 0.2,
                    rng.randn(32) * 0.5 + 1.0, rng.randn(32) * 0.2)]
    grad_of = {"x": ts[:1], "weights": ts[1:], "all": ts}[needs]
    for t in grad_of:
        t.requires_grad_(True)
    y = depth_tap_conv(*ts)
    _cuda.reset_launches()
    torch.autograd.grad(y, grad_of, torch.ones_like(y))
    assert _cuda.launches == {
        "psv_warp_fwd": 0, "psv_warp_bwd": 0, "depth_tap_conv_fwd": 0,
        "depth_tap_conv_bwd": int(needs != "weights"),
        "depth_tap_conv_wgrad": int(needs != "x")}


def test_tiny_training_step_matches_cpu(dev):
    # the tiny DSGN in fp32 (TF32 off): every parameter's gradient on the
    # card within 1e-3 x its largest magnitude of the CPU's (the same
    # arithmetic summed in other orders through ~40 layers); a Score3D
    # bias, whose gradient is 0 up to rounding (the softmax over planes
    # cancels it), against its weight's. A second step on the card, with
    # library kernels in deterministic mode as the training CLI runs,
    # gives every gradient bit for bit
    import dataclasses

    from eval_driving_safety_tpu_torch.config import DSGNConfig
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    from eval_driving_safety_tpu_torch.models.rpn3d_loss import \
        dsgn_total_loss
    cfg = dataclasses.replace(DSGNConfig.tiny(), dtype="float32")
    rng = np.random.RandomState(0)
    il = rng.randn(1, 96, 320, 3).astype(np.float32)
    ir = np.roll(il, -6, axis=2)
    depth = np.where(rng.rand(1, 96, 320) < 0.5,
                     rng.uniform(1.0, 70.0, (1, 96, 320)), 0.0)
    boxes = np.zeros((1, 4, 8), np.float32)
    boxes[0, 0] = [2.0, 1.6, 18.0, 1.5, 1.7, 4.0, 0.4, 1.0]
    cpu = DSGN(cfg).init_weights(3)
    card = DSGN(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)

    def grads(model, device):
        t = lambda a: torch.as_tensor(a).to(device)
        calib = [t(np.full((1,), v, np.float32))
                 for v in (180.0, 0.54, 160.0, 48.0)]
        out = model(t(il), t(ir), *calib)
        loss, _ = dsgn_total_loss(out, t(depth.astype(np.float32)),
                                  t(boxes), t(np.array([1])), cfg)
        loss.backward()
        return {k: p.grad.cpu() for k, p in model.named_parameters()}

    from eval_driving_safety_tpu_torch.cli.common import \
        use_deterministic_kernels
    use_deterministic_kernels(dev)
    try:
        _cuda.reset_launches()
        gk = grads(card, dev)
        assert _cuda.launches["depth_tap_conv_wgrad"] == 8
        assert _cuda.launches["depth_tap_conv_bwd"] == 8
        card.zero_grad(set_to_none=True)
        again = grads(card, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(again[k], v) for k, v in gk.items())
    gc = grads(cpu, "cpu")
    for name, want in gc.items():
        ref = name.replace(".bias", ".weight") \
            if name.startswith("depth_score") else name
        scale = float(gc[ref].abs().max())
        torch.testing.assert_close(gk[name], want, rtol=0, atol=1e-3 * scale,
                                   msg=name)


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


def _wgrad_case(dev, shape, seed, relu=True, dtype="bfloat16"):
    """Inputs in `dtype` at (B, D, N, C, F); the weight gradient through
    the wrapper (x needs no gradient) and its plain version under the
    kernel's own forward."""
    b, d, n, c, f = shape
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s_, sc=1.0, sh=0.0: torch.from_numpy(
        (rng.randn(*s_) * sc + sh).astype(np.float32)).to(dev, dt)
    x, dy = mk(b, d, n, 1, c, sc=0.5), mk(b, d, n, 1, f)
    w, inv, off = mk(3, c, f, sc=c ** -0.5), mk(f, sc=0.2, sh=1.0), \
        mk(f, sc=0.1)
    ws = [t.clone().requires_grad_(True) for t in (w, inv, off)]

    def grads():
        y = depth_tap_conv(x, *ws, relu=relu)
        return y, torch.autograd.grad(y, ws, dy)

    y, got = grads()
    want = reference_depth_tap_conv_wgrad(
        x[:, :, :, 0], y.detach()[:, :, :, 0], dy[:, :, :, 0], w, inv, relu)
    return got, want, grads


# the weight gradient's tolerance: one bf16 rounding step; in fp32 sums
# of ~1e5-3e6 f32 products over the whole grid in another order
WGRAD_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}


def _assert_wgrad_close(got, want, dtype="bfloat16"):
    for name, a, r in zip(("dW", "d inv", "d off"), got, want):
        atol = WGRAD_RTOL[dtype] * float(r.abs().max())
        torch.testing.assert_close(a.float(), r, atol=atol, rtol=0,
                                   msg=name)


# the training shapes (DSGNConfig()) with N cut to B * D * N ~ 1e5
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [
    (1, 64, 1563, 32, 32), (1, 32, 3125, 64, 64), (1, 16, 1872, 64, 64),
    (1, 144, 695, 32, 32)])
def test_wgrad_at_training_shapes(dev, shape, dtype):
    got, want, _ = _wgrad_case(dev, shape, seed=shape[1], dtype=dtype)
    _assert_wgrad_close(got, want, dtype)


def _slice_bounds(shape, dtype="bfloat16"):
    """The plane-tile index where each slice of the weight gradient
    starts, from the kernel's own pixel tile and workspace size."""
    b, d, n, c, f = shape
    tile, slices = wgrad_geometry(*shape, getattr(torch, dtype))
    items = b * -(-n // tile) * d
    return d, [s * items // slices for s in range(slices)]


# N ragged against the pixel tile (64 in bf16; 128, 32, 64 and 256 in
# fp32 at these widths), D of 1, 2, 3, 13, C != F, widths of 8, and
# slices that start or end inside a tile's run of planes
WGRAD_EDGES = [(2, 1, 65, 8, 16), (2, 2, 35, 16, 8), (2, 3, 1000, 8, 16),
               (2, 13, 130, 16, 8), (2, 13, 97, 64, 32),
               (2, 2, 2561, 32, 64), (2, 1, 129, 8, 16), (2, 2, 33, 64, 32),
               (1, 13, 65, 32, 32), (1, 1, 257, 8, 8)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", WGRAD_EDGES)
def test_wgrad_at_its_edges(dev, shape, relu, dtype):
    got, want, _ = _wgrad_case(dev, shape, seed=shape[2], relu=relu,
                               dtype=dtype)
    _assert_wgrad_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wgrad_edges_include_slices_ending_mid_tile(dev, dtype):
    mid = [s for s in WGRAD_EDGES
           if any(i % _slice_bounds(s, dtype)[0]
                  for i in _slice_bounds(s, dtype)[1])]
    assert len(mid) >= 3, mid


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(1, 64, 1563, 32, 32),
                                   (2, 13, 97, 64, 32), (2, 1, 129, 8, 16)])
def test_wgrad_is_bit_for_bit_from_call_to_call(dev, shape, dtype):
    got, _, grads = _wgrad_case(dev, shape, seed=7, dtype=dtype)
    for _ in range(3):
        again = grads()[1]
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", [(1, 64, 29952, 32, 32),
                                   (1, 16, 1872, 64, 64),
                                   (1, 24, 1872, 64, 64), (2, 13, 97, 8, 16),
                                   (1, 1, 1, 64, 8), (1, 0, 5, 32, 32)])
def test_wgrad_workspace_bytes(dev, shape):
    # one (F, 3C + 1) f32 partial per slice. bf16: a slice per k
    # plane-tiles of 64 pixels (k = 8 at widths up to 32, 4 at 64), at
    # most 396 and 264; fp32: a slice per 8 plane-tiles of its own tile,
    # cut to one or two whole waves of 132 past one
    b, d, n, c, f = shape
    items = b * -(-n // 64) * d
    k, most = (4, 264) if max(c, f) == 64 else (8, 396)
    slices = min(most, -(-items // k))
    assert wgrad_workspace_bytes(*shape) == 4 * slices * f * (3 * c + 1)
    tile, slices32 = wgrad_geometry(*shape, torch.float32)
    per_8 = -(-(b * -(-n // tile) * d) // 8)
    assert slices32 == (per_8 if per_8 <= 132 else
                        132 if per_8 < 264 else 264)
    assert wgrad_workspace_bytes(*shape, torch.float32) == \
        4 * slices32 * f * (3 * c + 1)
    with pytest.raises(ValueError):
        wgrad_workspace_bytes(1, 2, 3, 12, 8)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 12, device=dev)
    with pytest.raises(ValueError):          # C = 12 is not a tile width
        depth_tap_conv(x, torch.zeros(3, 12, 12, device=dev),
                       torch.ones(12, device=dev), torch.zeros(12, device=dev))
    with pytest.raises(TypeError):           # float16 is not compiled
        psv_warp(torch.zeros(1, 2, 8, 4, device=dev, dtype=torch.float16),
                 torch.zeros(1, 3, device=dev))
