"""The depth-tap conv's weight gradient as the port's kernels compute it
in bf16 and fp32 (`reference_depth_tap_conv_wgrad`: one product G = sum
A_d^T dm[d], then dW = inv * G, d inv = sum W * G, d off = sum dm) against
the JAX
package's Pallas backward (`_pallas_bwd`, in interpret mode, as
tests/test_torch_ops.py runs it) and against autograd of the port's plain
forward, on the CPU in fp32.

Tolerance: 1e-4 x the largest reference magnitude. Both sides sum the
same f32 products over the whole grid, in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_driving_safety_tpu.ops.pallas_depthconv as jdtc
from eval_driving_safety_tpu_torch.ops.depthconv import (
    reference_depth_tap_conv, reference_depth_tap_conv_wgrad)

T = torch.from_numpy
RTOL = 1e-4


def _inputs(d, c, f, seed, zero_inv=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, d, 4, 8, c) * 0.5).astype(np.float32)
    wk = (rng.randn(3, c, f) * 0.2).astype(np.float32)
    inv = (rng.randn(f) * 0.5 + 1.0).astype(np.float32)
    if zero_inv:
        inv[::3] = 0.0
    off = (rng.randn(f) * 0.2).astype(np.float32)
    dy = rng.randn(2, d, 4, 8, f).astype(np.float32)
    with torch.no_grad():
        y = reference_depth_tap_conv(T(x), T(wk), T(inv), T(off)).numpy()
    return x, wk, inv, off, y, dy


def _close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _wgrad(x, y, dy, wk, inv, relu):
    b, d, h, w, c = x.shape
    f = wk.shape[-1]
    return [t.numpy() for t in reference_depth_tap_conv_wgrad(
        T(x).reshape(b, d, h * w, c), T(y).reshape(b, d, h * w, f),
        T(dy).reshape(b, d, h * w, f), T(wk), T(inv), relu)]


def _check_against_pallas(monkeypatch, d, c, f, relu, zero_inv=False):
    monkeypatch.setattr(jdtc, "_FORCE_INTERPRET", True)
    x, wk, inv, off, y, dy = _inputs(d, c, f, seed=10 * d + c,
                                     zero_inv=zero_inv)
    b, _, h, w, _ = x.shape
    n = h * w
    dm = np.where(y > 0, dy, 0.0) if relu else dy
    coeffs = jnp.asarray(np.stack([inv, off]))
    _, jdw, jdco = jdtc._pallas_bwd(
        jnp.asarray(x.reshape(b, d, n, c)), jnp.asarray(wk), coeffs,
        jnp.asarray(dm.reshape(b, d, n, f)), jdtc.pick_nb(n, c, f, 4))
    dw, dinv, doff = _wgrad(x, y, dy, wk, inv, relu)
    jdco = np.asarray(jdco)
    _close(dw, np.asarray(jdw), "dW")
    _close(dinv, jdco[0], "d inv")
    _close(doff, jdco[1], "d off")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("d", [1, 2, 6])
@pytest.mark.parametrize("c,f", [(8, 16), (16, 8)])
def test_wgrad_matches_pallas_backward(monkeypatch, d, c, f, relu):
    _check_against_pallas(monkeypatch, d, c, f, relu)


# the paper's widths (the fp32 kernel's 32- and 64-wide lane tiles), at
# small N; inv = 0 in some columns at width 64
@pytest.mark.parametrize("c,f,relu,zero_inv", [
    (32, 32, True, False), (64, 64, False, False), (32, 64, True, False),
    (64, 32, False, False), (64, 64, True, True)])
def test_wgrad_matches_pallas_backward_at_paper_widths(monkeypatch, c, f,
                                                       relu, zero_inv):
    _check_against_pallas(monkeypatch, 3, c, f, relu, zero_inv)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("d,c,f,zero_inv", [
    (1, 8, 16, False), (2, 16, 8, False), (6, 8, 8, False),
    (5, 16, 32, True)])
def test_wgrad_matches_autograd_of_plain_forward(d, c, f, zero_inv, relu):
    # inv = 0 in some columns: the G formulation divides by nothing
    x, wk, inv, off, _, dy = _inputs(d, c, f, seed=d + f, zero_inv=zero_inv)
    args = [T(a).requires_grad_(True) for a in (wk, inv, off)]
    y = reference_depth_tap_conv(T(x), *args, relu=relu)
    want = torch.autograd.grad(y, args, T(dy))
    got = _wgrad(x, y.detach().numpy(), dy, wk, inv, relu)
    for name, a, b in zip(("dW", "d inv", "d off"), got, want):
        _close(a, b.numpy(), name)
