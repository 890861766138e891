"""The PSV warp wrappers' choices on the CPU: the access width the CUDA
kernels are launched with (`vector_bytes`, from C, the element size and
the tensors' addresses), the counted copy of a non-contiguous gradient,
the launch record, and the plain warp against the JAX reference at the
disparities the kernels treat as edges (negative, W - 1, past the row),
per image at B = 2.

Tolerances: forward atol 1e-5, gradients atol 1e-4 (fp32; the same
arithmetic summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.ops.pallas_psv import psv_warp as jax_psv_warp
from eval_driving_safety_tpu_torch.ops import _cuda
from eval_driving_safety_tpu_torch.ops.psv_warp import (_contiguous,
                                                        build_psv,
                                                        plane_disparities,
                                                        psv_from_disparities,
                                                        psv_warp,
                                                        vector_bytes)


@pytest.mark.parametrize("c,dtype,offset,width", [
    (32, torch.bfloat16, 0, 16),     # the paper's PSV: 16-byte accesses
    (32, torch.float32, 0, 16),
    (64, torch.bfloat16, 0, 16),
    (8, torch.bfloat16, 0, 16),      # the tiny model's C
    (4, torch.bfloat16, 0, 8),
    (12, torch.bfloat16, 0, 8),
    (6, torch.bfloat16, 0, 4),
    (3, torch.bfloat16, 0, 2),
    (2, torch.float32, 0, 8),
    (3, torch.float32, 0, 4),
    (32, torch.bfloat16, 2, 2),      # views off a 16-byte boundary
    (32, torch.bfloat16, 4, 4),
    (32, torch.bfloat16, 8, 8),
    (32, torch.float32, 4, 4),
    (32, torch.float32, 8, 8),
    (4, torch.bfloat16, 8, 8),
])
def test_vector_bytes_is_the_widest_that_fits(c, dtype, offset, width):
    size = torch.empty((), dtype=dtype).element_size()
    assert vector_bytes(c, size, 4096 + offset, 8192) == width
    # every pointer counts, in any position
    assert vector_bytes(c, size, 8192, 4096 + offset) == width


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vector_bytes_reads_tensor_addresses(dtype):
    buf = torch.empty(4096, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    size = buf.element_size()
    assert vector_bytes(32, size, buf.data_ptr()) == 16
    view = buf[1:]
    assert vector_bytes(32, size, buf.data_ptr(), view.data_ptr()) == size


def test_noncontiguous_gradient_copy_is_counted():
    _cuda.reset_launches()
    t = torch.randn(2, 3, 4, 6)
    assert _contiguous(t) is t and not _cuda.align_copies
    nc = t.transpose(-1, -2)
    out = _contiguous(nc)
    assert out.is_contiguous() and torch.equal(out, nc)
    assert _cuda.align_copies == {"psv_warp": 1}
    _cuda.reset_launches()
    assert not _cuda.align_copies


def test_count_launch_records_the_access_width():
    _cuda.reset_launches()
    _cuda.count_launch("psv_warp_fwd", (1, 96, 96, 312, 32), torch.bfloat16,
                       16)
    _cuda.count_launch("psv_warp_bwd", (1, 96, 96, 312, 32), torch.bfloat16,
                       2)
    _cuda.count_launch("depth_tap_conv_fwd", (1, 2, 4, 8, 8), torch.float32)
    assert _cuda.launch_widths == {("psv_warp_fwd", 16): 1,
                                   ("psv_warp_bwd", 2): 1}
    assert sum(_cuda.launches.values()) == 3
    _cuda.reset_launches()
    assert not _cuda.launch_widths


def test_psv_warp_edge_disparities_match_pallas():
    # per image at B = 2: no shift, whole, W - 1, past the row, negative
    rng = np.random.RandomState(7)
    b, h, w, c = 2, 5, 24, 4
    disps = np.array([[0.0, 3.0, w - 1.0, w + 4.5, -0.5, 2.25],
                      [1.5, -0.5, 0.0, 40.25, w - 1.0, 7.75]], np.float32)
    fr = rng.randn(b, h, w, c).astype(np.float32)
    g = rng.randn(b, disps.shape[1], h, w, c).astype(np.float32)
    frt = torch.from_numpy(fr).requires_grad_(True)
    got = psv_warp(frt, torch.from_numpy(disps))
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), frt)
    for i in range(b):
        d = jnp.asarray(disps[i])
        want = np.asarray(jax_psv_warp(jnp.asarray(fr[i]), d))
        want_g = np.asarray(jax.grad(
            lambda f: jnp.sum(jax_psv_warp(f, d) * g[i]))(jnp.asarray(fr[i])))
        np.testing.assert_allclose(got[i].detach().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got_g[i].numpy(), want_g, atol=1e-4)


def test_build_psv_is_the_volume_at_the_planes_disparities():
    rng = np.random.RandomState(8)
    fl, fr = (torch.from_numpy(rng.randn(2, 4, 16, 8).astype(np.float32))
              for _ in range(2))
    fu, bl = torch.tensor([180.0, 150.0]), torch.tensor([0.54, 0.5])
    planes = torch.linspace(2.0, 59.6, 5)
    disps = plane_disparities(fu, bl, planes, 4)
    want = psv_from_disparities(fl, fr, disps)
    assert want.shape == (2, 5, 4, 16, 16)
    assert torch.equal(want[..., :8], fl[:, None].expand(-1, 5, -1, -1, -1))
    assert torch.equal(want[..., 8:], psv_warp(fr, disps))
    assert torch.equal(build_psv(fl, fr, fu, bl, planes, 4), want)
