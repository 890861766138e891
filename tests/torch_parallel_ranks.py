"""Rank code of tests/test_torch_parallel.py: the twins of
tests/test_parallel.py's sharded PGD and patch steps and the (1, 2) mesh
at world 2, the loss helpers on the (2, 2) mesh at world 4, run as the
ranks of a gloo launch (`python tests/torch_parallel_ranks.py OUT`, one process per
rank with the torchrun environment, chip_smoke.launch_ranks). Each rank
writes its results to OUT with "{rank}" replaced by its rank. Imports no
JAX: the inputs are seeded numpy arrays that the test feeds to the JAX
functions too."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from eval_driving_safety_tpu_torch.parallel import sharding as S  # noqa

PGD = dict(alpha=0.1, eps=0.25, clip_min=0.0, clip_max=2.0)
PATCH = dict(alpha=1.0, eps=10.0)


def pgd_inputs():
    """(8, 16, 16, 3) left and right views; rows 4-7 brighter than rows
    0-3, so each half's mask counts differ from the batch's."""
    rng = np.random.RandomState(0)
    lo = np.r_[np.zeros(4), np.full(4, 0.3)][:, None, None, None]
    left = (lo + (1 - lo) * rng.rand(8, 16, 16, 3)).astype(np.float32)
    right = rng.rand(8, 16, 16, 3).astype(np.float32)
    return left, right


def patch_inputs():
    """(4, 16, 16, 3) views, a (5, 5, 3) patch and (4, 2) centres."""
    rng = np.random.RandomState(1)
    imgs_l = rng.rand(4, 16, 16, 3).astype(np.float32)
    imgs_r = rng.rand(4, 16, 16, 3).astype(np.float32)
    patch = rng.rand(5, 5, 3).astype(np.float32)
    centers_l = rng.randint(-2, 18, (4, 2)).astype(np.int32)
    centers_r = rng.randint(-2, 18, (4, 2)).astype(np.int32)
    return imgs_l, imgs_r, patch, centers_l, centers_r


def square_loss(l, r):
    """tests/test_parallel.py's loss."""
    return (l ** 2).sum() + (r ** 2).sum()


def coupled_loss(l, r, total=lambda n: n, clamp=None):
    """Two terms over two batch counts: the sign of a pixel's gradient,
    m1 / n1 - 2 l m2 / n2, turns on the ratio of the counts, so per-rank
    counts step otherwise. `total` sums a count over the batch (the
    identity in one process; `S.global_sum` on a split batch); `clamp`
    defaults to torch's (the JAX test passes jnp's)."""
    clamp = clamp or (lambda n: torch.clamp_min(n, 1.0))
    m1 = (l > 0.5) * 1.0
    m2 = (r < 0.7) * 1.0
    return ((l * m1).sum() / clamp(total(m1.sum()))
            - (l ** 2 * m2).sum() / clamp(total(m2.sum()))
            + (r * m2).sum() / clamp(total(m2.sum())))


def patch_loss(l, r, total=lambda n: n, clamp=None):
    """The patch twin's loss, with a normalizer over the batch."""
    clamp = clamp or (lambda n: torch.clamp_min(n, 1.0))
    return (l ** 2).sum() / clamp(total(((l > 0.5) * 1.0).sum())) \
        + (r ** 2).sum()


def mesh_record(mesh):
    """A mesh's axes, this rank's place on them and its groups' ranks
    (-1 for a group that is the whole world or None)."""
    import torch.distributed as dist
    ranks = lambda g: dist.get_process_group_ranks(g) if g is not None \
        else [-1]
    return {"axes": [mesh.n_data, mesh.n_model, mesh.data_rank,
                     mesh.model_rank],
            "model_group": ranks(mesh.model_group),
            "data_group": ranks(mesh.data_group)}


def data_group_helpers(mesh):
    """PR 16's loss helpers on a batch of 4 rows split over `mesh`'s data
    rows: each rank's sum of rank + 1, the mean of (2 rows of) rank, the
    gathered (2 rows of) rank, its first share, rows and writes."""
    sharding = S.dp_sharding(mesh, 4)
    r = float(mesh.rank)
    with sharding:
        res = {"sum": S.global_sum(torch.tensor([r + 1])).numpy(),
               "mean": S.global_mean(torch.full((2, 3), r)).numpy(),
               "gathered": S.gather_rows(torch.full((2, 1), r)).numpy(),
               "first_share": np.array(S.is_first_share())}
    res["rows"] = np.array([sharding.rows.start, sharding.rows.stop])
    res["writes"] = np.array(sharding.writes)
    return res


def main(out):
    mesh = S.init_process_group("cpu")
    if mesh.world == 4:
        # the (2, 2) mesh: the loss helpers over the data group only
        mesh = S.make_mesh(2, 2)
        res = {**data_group_helpers(mesh),
               **{k: np.array(v) for k, v in mesh_record(mesh).items()}}
        np.savez(out.replace("{rank}", str(mesh.rank)), **res)
        S.destroy_process_group()
        return
    assert S.make_mesh(2, 1) == mesh and mesh.world == 2
    res = {f"mesh12_{k}": np.array(v)
           for k, v in mesh_record(S.make_mesh(1, 2)).items()}
    left, right = (torch.from_numpy(a) for a in pgd_inputs())
    sharding = S.dp_sharding(mesh, len(left))
    for name, loss in (("square", square_loss),
                       ("coupled", lambda l, r: coupled_loss(
                           l, r, S.global_sum)),
                       ("per_rank", coupled_loss)):
        step = S.sharded_pgd_step(loss, mesh, **PGD)
        with sharding:
            bl, br = S.shard_batch((left, right), sharding)
            al, ar, l0 = step(bl, br, bl, br)
        res[name + "_l"], res[name + "_r"] = al.numpy(), ar.numpy()
        res[name + "_loss"] = l0.numpy()
    imgs_l, imgs_r, patch, cl, cr = (torch.from_numpy(a)
                                     for a in patch_inputs())
    sharding = S.dp_sharding(mesh, len(imgs_l))
    step = S.sharded_patch_step(
        lambda l, r: patch_loss(l, r, S.global_sum), mesh, **PATCH)
    with sharding:
        il, ir, rcl, rcr = S.shard_batch((imgs_l, imgs_r, cl, cr), sharding)
        new_patch, l0 = step(patch, il, ir, rcl, rcr)
    res["patch"], res["patch_loss"] = new_patch.numpy(), l0.numpy()
    np.savez(out.replace("{rank}", str(mesh.rank)), **res)
    S.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
