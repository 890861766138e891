"""The batch split over `torch.distributed`: data parallelism for the
attack sweeps and the universal patch.

Counterpart of eval_driving_safety_tpu/parallel/sharding.py. JAX shards a
batch's leading axis over a device mesh and lets the SPMD partitioner
insert the reductions; here each process of a `torchrun` launch is one
rank of the data axis, and the reductions are written out:

* the world comes from the torchrun environment (WORLD_SIZE, RANK,
  LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Without it the world is one
  process, no process group is made and every collective below is the
  identity; a partial environment, or a process group that cannot be
  made, raises;
* a global batch whose size divides by the world size is split into
  contiguous blocks of rows, rank r taking block r (`dp_sharding`); any
  other batch stays whole on every rank, as JAX replicates it, and rank
  0 alone writes its outputs;
* while a split batch is computed (`with sharding:`), `global_sum` adds
  a loss's normalizers (counts, mask sums) over the ranks and
  `global_mean` divides by the global row count, so each rank's loss is
  its share of the whole batch's loss, whose input gradients are those
  of the whole batch's loss row by row; `is_first_share` lets one rank
  alone add the loss's constant terms;
* the universal patch stays replicated: `gather_rows` collects the
  ranks' per-row patch gradients in the global batch's row order, and
  every rank sums them in the order one process does
  (`attack.patch.patch_update_step`).

NCCL serves ranks that each have a card of their own; ranks that share a
card, and ranks on the CPU, use gloo (NCCL refuses two ranks on one
device), which reduces host copies of the (small) tensors.

The model axis (the JAX package's `constrain_psv`, the depth planes of
the plane-sweep volume over devices) is not here: `make_mesh` refuses it.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# the torchrun variables a rank needs; all or none must be set
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """The data axis: `world` ranks, this process being `rank`, which
    computes on `device`."""
    world: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")


def torchrun_env() -> Optional[dict]:
    """The torchrun variables as ints (addresses as strings), or None
    where none is set; raises where some but not all are."""
    have = {k: os.environ[k] for k in TORCHRUN_ENV if os.environ.get(k)}
    if not have:
        return None
    missing = [k for k in TORCHRUN_ENV if k not in have]
    if missing:
        raise RuntimeError(
            f"a partial torchrun environment: {sorted(have)} set, {missing} "
            "not; launch with torchrun, or set none of them for one process")
    env = {k: int(v) for k, v in have.items() if k != "MASTER_ADDR"}
    env["MASTER_ADDR"] = have["MASTER_ADDR"]
    if not 0 <= env["RANK"] < env["WORLD_SIZE"]:
        raise ValueError(f"RANK {env['RANK']} is not below WORLD_SIZE "
                         f"{env['WORLD_SIZE']}")
    return env


def rank_device(device: str, local_rank: int) -> torch.device:
    """The rank's device: `cuda` names card LOCAL_RANK modulo the cards
    present; `cpu`, or a card with an index, is taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_process_group(device: str = "cuda",
                       timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """Join the torchrun launch this process belongs to and return its
    Mesh. Without the torchrun environment, or in a world of one, no
    process group is made and the mesh is one process on `device`."""
    env = torchrun_env()
    if env is None or env["WORLD_SIZE"] == 1:
        return Mesh(device=torch.device(device))
    world, rank, local = env["WORLD_SIZE"], env["RANK"], env["LOCAL_RANK"]
    dev = rank_device(device, local)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    own_card = (dev.type == "cuda" and dev.index == local
                and local_world <= torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if own_card:
        kw["device_id"] = dev
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method="env://", world_size=world,
                            rank=rank, **kw)
    return Mesh(world, rank, dev)


def destroy_process_group() -> None:
    """Leave the process group, if one was made."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cpu") -> Mesh:
    """The data axis of this process's group (`init_process_group`; one
    process without one), which must have `n_data` ranks where that is
    given, computing on `device`. The model axis is not ported."""
    if n_model != 1:
        raise NotImplementedError(
            "the model axis (depth planes over devices, the JAX package's "
            "constrain_psv) is not ported; ROADMAP item 17 holds it")
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    if n_data is not None and n_data != world:
        raise ValueError(f"make_mesh({n_data}) in a world of {world} "
                         f"ranks; launch {n_data} ranks with torchrun")
    return Mesh(world, rank, torch.device(device))


def barrier() -> None:
    """Wait for every rank (nothing to wait for in a world of one)."""
    if dist.is_initialized():
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first(mesh: Mesh):
    """Run the block on rank 0 of `mesh` before its other ranks run it, so
    that a file rank 0 makes there is on disk for them."""
    if mesh.rank != 0:
        barrier()
    yield
    if mesh.rank == 0:
        barrier()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("batch_sharding",
                                                         default=None)


@dataclass
class BatchSharding:
    """How a global batch of `n` rows lies on the data axis: split into
    contiguous blocks of rows, or, where `n` does not divide by the world
    size (or the world is one process), whole on every rank. Inside `with
    sharding:` the loss helpers below reduce over the ranks that share
    the batch."""
    mesh: Mesh
    n: int
    split: bool

    @property
    def rows(self) -> slice:
        """This rank's rows of the global batch."""
        if not self.split:
            return slice(0, self.n)
        k = self.n // self.mesh.world
        return slice(self.mesh.rank * k, (self.mesh.rank + 1) * k)

    @property
    def writes(self) -> bool:
        """Whether this rank writes the outputs of its rows: every rank of
        a split batch, rank 0 alone of a replicated one."""
        return self.split or self.mesh.rank == 0

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)


def dp_sharding(mesh: Mesh, n: int) -> BatchSharding:
    """The rule of a batch of `n` rows: split over the ranks where `n`
    divides by the world size, else whole on every rank (replicated)."""
    return BatchSharding(mesh, n, mesh.world > 1 and n % mesh.world == 0)


def shard_batch(tree, sharding: BatchSharding):
    """This rank's rows of every batch-leading entry of `tree` (dicts,
    lists, tuples and named tuples of tensors, arrays and per-row lists):
    an entry whose leading size is the batch's is sliced, anything else
    (scalars, shared tables) is kept whole."""
    rows = sharding.rows

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [take(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if isinstance(x, (list, np.ndarray, torch.Tensor)) and \
                getattr(x, "ndim", 1) >= 1 and len(x) == sharding.n:
            return x[rows]
        return x
    return take(tree) if sharding.split else tree


def _sharding() -> Optional[BatchSharding]:
    s = _ACTIVE.get()
    return s if s is not None and s.split else None


def _host(x: torch.Tensor) -> torch.Tensor:
    """A copy of `x` that the process group's backend reduces: gloo
    reduces host tensors."""
    x = x.detach()
    if dist.get_backend() == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x.clone()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (a detached count or sum) summed over the ranks that share the
    batch being computed; `x` itself where the batch is not split."""
    if _sharding() is None:
        return x
    t = _host(x)
    dist.all_reduce(t)
    return t.to(x.device)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x`'s entries over the whole batch (x's rows on every
    rank): `x.mean()` where the batch is not split."""
    s = _sharding()
    if s is None:
        return x.mean()
    return x.sum() / (x.numel() * s.mesh.world)


def is_first_share() -> bool:
    """Whether this rank's share of the loss carries the batch's constant
    terms: rank 0 of a split batch, every rank of a whole one."""
    s = _sharding()
    return s is None or s.mesh.rank == 0


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of `x` from every rank, in rank order (the global batch's
    row order), detached; `x` itself where the batch is not split."""
    if _sharding() is None:
        return x
    t = _host(x)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).to(x.device)


def sharded_pgd_step(loss_fn: Callable, mesh: Mesh, *, alpha, eps,
                     clip_min, clip_max):
    """One PGD iteration on this rank's rows of a batch.

    Returns step(adv_l, adv_r, clean_l, clean_r) -> (adv_l, adv_r, loss),
    to be called inside the batch's sharding (`with sharding:`) on the
    rows `shard_batch` gave; `loss_fn` takes global normalizers
    (`global_sum`). The pixel gradients stay on their rank; the loss,
    summed over the ranks, is the only cross-rank reduction."""
    del mesh                                  # the sharding carries it

    def step(adv_l, adv_r, clean_l, clean_r):
        vl = adv_l.detach().requires_grad_(True)
        vr = adv_r.detach().requires_grad_(True)
        loss = loss_fn(vl, vr)
        gl, gr = torch.autograd.grad(loss, (vl, vr))
        out = []
        for adv, g, clean in ((adv_l, gl, clean_l), (adv_r, gr, clean_r)):
            adv = clean + torch.clamp(adv + alpha * torch.sign(g) - clean,
                                      -eps, eps)
            out.append(torch.clamp(adv, clip_min, clip_max))
        return out[0], out[1], global_sum(loss.detach())
    return step


def sharded_patch_step(loss_fn: Callable, mesh: Mesh, *, alpha: float,
                       eps: float):
    """One universal-patch descent step on this rank's rows of a batch.

    Returns step(patch, imgs_l, imgs_r, centers_l, centers_r) ->
    (patch, loss), to be called inside the batch's sharding. The patch is
    replicated; its gradient is the sum over the global batch's rows
    (`attack.patch.patch_update_step`), the same bits on every rank."""
    from eval_driving_safety_tpu_torch.attack.patch import patch_update_step
    del mesh

    def step(patch, imgs_l, imgs_r, centers_l, centers_r):
        return patch_update_step(loss_fn, patch, imgs_l, imgs_r, centers_l,
                                 centers_r, alpha=alpha, eps=eps)
    return step
