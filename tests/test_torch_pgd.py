"""The port's PGD engine and sign-transfer contract against the JAX
package: packed bytes are identical, iterates on an analytic loss are
identical, and the port's own packed signs replay its device iterates
bit-exactly (exact comparisons throughout: every value involved is
exactly representable, see attack.pgd)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.attack import pgd as J
from eval_driving_safety_tpu.data.dataset import u8_to_01 as jax_u8_to_01
from eval_driving_safety_tpu_torch.attack import pgd as P
from eval_driving_safety_tpu_torch.data.dataset import (fetch_packed_signs,
                                                        u8_to_01)

SHAPE = (2, 8, 16, 3)


def test_pack_signs_and_bits_bytes_equal_jax():
    s = np.random.RandomState(0).randint(-1, 2, (4, *SHAPE)).astype(
        np.float32)
    assert np.array_equal(P.pack_signs(torch.from_numpy(s)).numpy(),
                          np.asarray(J.pack_signs(jnp.asarray(s))))
    for plane in (s > 0, s == 0):
        assert np.array_equal(P.pack_bits(torch.from_numpy(plane)).numpy(),
                              np.asarray(J.pack_bits(jnp.asarray(plane))))
    with pytest.raises(ValueError):
        P.pack_signs(torch.zeros(1, 4, 5, 3))
    with pytest.raises(ValueError):
        P.pack_bits(torch.zeros(1, 4, 5, 3, dtype=torch.bool))


def test_signs1_conversion_matches_jax_and_takes_any_layout():
    s = np.random.RandomState(1).randint(-1, 2, (3, *SHAPE)).astype(
        np.float32)
    pos = np.asarray(J.pack_bits(jnp.asarray(s > 0)))
    zero = np.asarray(J.pack_bits(jnp.asarray(s == 0)))
    want = np.asarray(J.pack_signs(jnp.asarray(s)))
    assert np.array_equal(P.signs1_to_packed2(pos, zero), want)
    # a non-contiguous view (here the iteration axis moved last, then
    # back) must convert the same as its contiguous copy
    pos_t = np.moveaxis(np.moveaxis(pos, 0, -1).copy(), -1, 0)
    zero_t = np.moveaxis(np.moveaxis(zero, 0, -1).copy(), -1, 0)
    assert not pos_t.flags.c_contiguous
    assert np.array_equal(P.signs1_to_packed2(pos_t, zero_t), want)
    assert np.array_equal(P.unpack_signs(want), s)


def _toy_loss(lib):
    """Analytic loss with sign structure that flips across iterations; its
    gradient a c cos(a x + b) is far from zero almost everywhere, so both
    frameworks see the same signs."""
    rng = np.random.RandomState(2)
    a, b, c = (rng.uniform(0.05, 0.2, SHAPE[1:]).astype(np.float32),
               rng.uniform(0, 6, SHAPE[1:]).astype(np.float32),
               rng.randn(*SHAPE[1:]).astype(np.float32))
    t = rng.uniform(0, 255, SHAPE[1:]).astype(np.float32)
    if lib == "jax":
        return lambda il, ir: jnp.sum(jnp.sin(a * il + b) * c) \
            - 0.01 * jnp.sum((ir - t) ** 2)
    a, b, c, t = map(torch.from_numpy, (a, b, c, t))
    return lambda il, ir: torch.sum(torch.sin(a * il + b) * c) \
        - 0.01 * torch.sum((ir - t) ** 2)


def _clean(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, SHAPE).astype(np.float32),
            rng.randint(0, 256, SHAPE).astype(np.float32))


KW = dict(alpha=np.float32(1.0), eps=np.float32(3.5), clip_min=0.0,
          clip_max=255.0)


def test_pgd_iterates_equal_jax():
    cl, cr = _clean()
    n = 6
    want = jax.jit(lambda l, r: J.pgd_attack(
        _toy_loss("jax"), l, r, num_iters=n, collect=True, **KW))(
        jnp.asarray(cl), jnp.asarray(cr))
    got = P.pgd_attack(_toy_loss("torch"), torch.from_numpy(cl),
                       torch.from_numpy(cr), num_iters=n, collect=True, **KW)
    for k in range(n):
        assert np.array_equal(got.trajectory[0][k].numpy(),
                              np.asarray(want.trajectory[0][k])), k
        assert np.array_equal(got.trajectory[1][k].numpy(),
                              np.asarray(want.trajectory[1][k])), k
    # losses: the same f32 function summed in another order
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-5)
    # the ball engaged, so the projection is covered too
    assert np.abs(got.adv_left.numpy() - cl).max() == 3.5


@pytest.mark.parametrize("collect", ["signs", "signs1"])
def test_packed_signs_replay_own_iterates_bitwise(collect):
    cl, cr = _clean(4)
    n = 5
    full = P.pgd_attack(_toy_loss("torch"), torch.from_numpy(cl),
                        torch.from_numpy(cr), num_iters=n, collect=True, **KW)
    packed = P.pgd_attack(_toy_loss("torch"), torch.from_numpy(cl),
                          torch.from_numpy(cr), num_iters=n, collect=collect,
                          **KW)
    assert torch.equal(full.adv_left, packed.adv_left)
    pl, pr, bits = fetch_packed_signs(*packed.trajectory)
    assert bits == (1 if collect == "signs1" else 2)
    if bits == 1:
        pl, pr = P.signs1_to_packed2(pl), P.signs1_to_packed2(pr)
    replayed = list(P.replay_pgd(cl, cr, pl, pr, **KW))
    quantized = list(P.replay_pgd_255(cl.astype(np.uint8),
                                      cr.astype(np.uint8), pl, pr,
                                      eps=KW["eps"]))
    for k in range(n):
        for side in (0, 1):
            dev = full.trajectory[side][k].numpy()
            assert np.array_equal(replayed[k][side], dev), (k, side)
            assert np.array_equal(quantized[k][side],
                                  dev.astype(np.uint8)), (k, side)


def test_signs1_zero_gradient_fetches_zero_plane():
    """A loss with a dead input region has exact zero gradients: the zero
    counts trigger the zero-plane fetch and the codes still replay."""
    cl, cr = _clean(5)
    mask = torch.ones(SHAPE)
    mask[:, :2] = 0.0
    loss = lambda il, ir: torch.sum(torch.sin(0.1 * il) * mask) \
        + torch.sum(ir * mask)
    full = P.pgd_attack(loss, torch.from_numpy(cl), torch.from_numpy(cr),
                        num_iters=3, collect=True, **KW)
    s1 = P.pgd_attack(loss, torch.from_numpy(cl), torch.from_numpy(cr),
                      num_iters=3, collect="signs1", **KW)
    pl, pr, bits = fetch_packed_signs(*s1.trajectory)
    assert bits == 2
    for k, (xl, xr) in enumerate(P.replay_pgd(cl, cr, pl, pr, **KW)):
        assert np.array_equal(xl, full.trajectory[0][k].numpy())
        assert np.array_equal(xr, full.trajectory[1][k].numpy())


def test_u8_to_01_exhaustive():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    want = u8.astype(np.float32) / 255.0
    assert np.array_equal(u8_to_01(torch.from_numpy(u8)).numpy(), want)
    assert np.array_equal(u8_to_01(u8), want)
    assert np.array_equal(np.asarray(jax_u8_to_01(jnp.asarray(u8))), want)
