"""The model axis: DSGN's plane-sweep volume split by depth plane over the
ranks of a model group.

Counterpart of eval_driving_safety_tpu/parallel/sharding.py's
`constrain_psv`, which annotates the volume (B, D, H, W, C) with its
depth planes over the mesh's `model` axis and lets XLA insert the halo
exchanges and the gathers. Here they are written out. Model rank m of n
holds planes [m D/n, (m+1) D/n) (`VolumeShard.planes`); D must divide by
4 n, so that both stride-2 depth stages of the hourglasses halve an even
count on every rank. Each primitive is an autograd Function whose
backward is the true adjoint of its forward, given that everything
downstream of a gather is computed alike on every model rank (so each
rank holds the whole gradient there, and none may be summed twice):

* `copy_to_model`: the identity forward; backward, the ranks' partial
  gradients summed over the model group (in f32). It stands where the
  replicated stereo features enter the sharded volume, so every rank's
  image gradient is the whole one;
* `gather_planes`: the ranks' slices concatenated along dim 1 (`sizes`
  may differ from rank to rank); backward, the rank's own slice of the
  gradient, not summed;
* `halo_exchange(x, shard, lo, hi)`: the rank's planes with `lo` planes
  of the previous model rank before them and `hi` of the next after
  them, zero planes at the global ends (which is the convs' zero
  padding); backward, the halo planes' gradients sent back to the ranks
  that own those planes and added there.

A model enters the axis through `enter_volume` (its features under
`copy_to_model`, its rank's plane depths), which refuses weights that
need a gradient (`require_frozen`).

`torch.distributed.nn.functional.all_reduce` all-reduces in backward
too: where its consumer is replicated, every rank's gradient would count
n times. None of these primitives does that.

Ranks that share a card, and CPU ranks, talk over gloo, which moves host
copies (each staged here, and the result put back on the rank's
device); ranks with a card each use NCCL on the device. `traffic` counts,
for each primitive and direction, the calls, the bytes this rank handed
to the backend and the host seconds of the calls, staging included;
`reset_traffic` zeroes it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from eval_driving_safety_tpu_torch.parallel.sharding import Mesh

traffic: Dict[str, Dict[str, float]] = {}


def reset_traffic() -> None:
    traffic.clear()


def _record(name: str, nbytes: int, t0: float) -> None:
    r = traffic.setdefault(name, {"calls": 0, "bytes": 0, "host_s": 0.0})
    r["calls"] += 1
    r["bytes"] += nbytes
    r["host_s"] += time.perf_counter() - t0


@dataclass(frozen=True)
class VolumeShard:
    """This rank's part of the model axis: model rank `rank` of `n` in
    `group` (the mesh's model group, the ranks of one data row)."""
    mesh: Mesh

    @property
    def n(self) -> int:
        return self.mesh.n_model

    @property
    def rank(self) -> int:
        return self.mesh.model_rank

    @property
    def group(self):
        return self.mesh.model_group

    def planes(self, d: int) -> Tuple[int, int]:
        """[lo, hi): this rank's planes of a volume of `d`."""
        if d % (4 * self.n):
            raise ValueError(
                f"{d} depth planes over {self.n} model ranks: the planes "
                f"must divide by 4 x {self.n} = {4 * self.n}, so that every "
                "rank halves an even count at both stride-2 depth stages")
        k = d // self.n
        return self.rank * k, (self.rank + 1) * k

    def peer(self, step: int) -> Optional[int]:
        """The global rank `step` model ranks away in this data row, or
        None past either end."""
        m = self.rank + step
        if not 0 <= m < self.n:
            return None
        return self.mesh.data_rank * self.n + m


def constrain_psv(mesh: Mesh) -> Optional[VolumeShard]:
    """What the DSGN models take as `volume_constraint`: this rank's part
    of the model axis of `mesh`, or None where the axis is one rank (the
    unsharded path)."""
    return VolumeShard(mesh) if mesh.n_model > 1 else None


def require_frozen(model: torch.nn.Module) -> None:
    """Raise if autograd would give one of `model`'s parameters a
    gradient: on the model axis each rank would hold its planes' part of
    a weight gradient, summed nowhere. Every path that reaches the axis
    (the attacks, the patch, the dry run) freezes the weights; the JAX
    trainer never builds a model axis."""
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in model.parameters()):
        raise RuntimeError(
            "the model axis takes input gradients only: a parameter that "
            "needs a gradient would get each rank's partial weight "
            "gradient (no trainer builds a model axis); freeze the weights "
            "with requires_grad_(False)")


def enter_volume(model: torch.nn.Module, shard: Optional[VolumeShard],
                 fl: torch.Tensor, fr: torch.Tensor, planes: torch.Tensor):
    """(fl, fr, planes) a model builds its plane-sweep volume from: on the
    model axis the stereo features with their gradient summed over the
    model group and this rank's plane depths, once the model is found
    frozen; without one (`shard` None) as they are."""
    if shard is None:
        return fl, fr, planes
    require_frozen(model)
    lo, hi = shard.planes(planes.shape[0])
    return copy_to_model(fl, shard), copy_to_model(fr, shard), planes[lo:hi]


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as the backend takes it: contiguous, a host copy for gloo."""
    x = x.detach().contiguous()
    return x.cpu() if _gloo(group) and x.is_cuda else x


def _empty(shape, like: torch.Tensor, group) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype,
                       device="cpu" if _gloo(group) else like.device)


def _all_reduce(x: torch.Tensor, shard: VolumeShard, name: str):
    """`x` summed over the model group, in f32 for 16-bit floats."""
    t0 = time.perf_counter()
    wide = x.float() if x.element_size() < 4 and x.is_floating_point() \
        else x
    t = _wire(wide, shard.group)
    if t.data_ptr() == x.data_ptr():
        t = t.clone()
    dist.all_reduce(t, group=shard.group)
    _record(name, t.numel() * t.element_size(), t0)
    return t.to(x.device, x.dtype)


def _swap(shard: VolumeShard, to_prev, to_next, n_prev: int, n_next: int,
          like: torch.Tensor, name: str):
    """Send `to_prev` (planes along dim 1, or None) to the previous model
    rank and `to_next` to the next; receive `n_prev` planes from the
    previous and `n_next` from the next (shaped as `like` but for dim 1).
    Returns (from previous, from next), None where nothing came."""
    t0 = time.perf_counter()
    prev, nxt = shard.peer(-1), shard.peer(1)
    ops, sent, got = [], 0, [None, None]
    for peer, out in ((prev, to_prev), (nxt, to_next)):
        if peer is not None and out is not None and out.shape[1]:
            t = _wire(out, None)
            ops.append(dist.P2POp(dist.isend, t, peer))
            sent += t.numel() * t.element_size()
    for i, (peer, k) in enumerate(((prev, n_prev), (nxt, n_next))):
        if peer is not None and k:
            got[i] = _empty((like.shape[0], k, *like.shape[2:]), like, None)
            ops.append(dist.P2POp(dist.irecv, got[i], peer))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got = [None if g is None else g.to(like.device) for g in got]
    _record(name, sent, t0)
    return got


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard, "copy_to_model.bwd"), None


class _GatherPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, sizes):
        ctx.shard, ctx.sizes = shard, sizes
        t0 = time.perf_counter()
        width = max(sizes)
        if x.shape[1] < width:
            x = torch.cat([x, x.new_zeros((x.shape[0], width - x.shape[1],
                                           *x.shape[2:]))], 1)
        t = _wire(x, shard.group)
        parts = [_empty(t.shape, t, shard.group) for _ in range(shard.n)]
        dist.all_gather(parts, t, group=shard.group)
        out = torch.cat([p[:, :k] for p, k in zip(parts, sizes)],
                        1).to(x.device)
        _record("gather_planes.fwd", t.numel() * t.element_size(), t0)
        return out

    @staticmethod
    def backward(ctx, g):
        r = ctx.shard.rank
        start = sum(ctx.sizes[:r])
        return g[:, start:start + ctx.sizes[r]], None, None


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, lo, hi):
        d = x.shape[1]
        if lo > d or hi > d:
            raise ValueError(f"a halo of ({lo}, {hi}) planes around {d}")
        ctx.shard, ctx.lo, ctx.hi = shard, lo, hi
        # the previous rank takes my first `hi` planes as its high halo,
        # the next my last `lo` as its low one
        got_prev, got_next = _swap(shard, x[:, :hi], x[:, d - lo:], lo, hi,
                                   x, "halo_exchange.fwd")
        zeros = lambda k: x.new_zeros((x.shape[0], k, *x.shape[2:]))
        return torch.cat([zeros(lo) if got_prev is None else got_prev, x,
                          zeros(hi) if got_next is None else got_next], 1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.lo, ctx.hi
        d = g.shape[1] - lo - hi
        # the halos' gradients go back to their owners; mine come from the
        # next rank (for my last `lo` planes) and the previous (my first
        # `hi`)
        got_prev, got_next = _swap(ctx.shard, g[:, :lo], g[:, lo + d:], hi,
                                   lo, g, "halo_exchange.bwd")
        dx = g[:, lo:lo + d].clone()
        if got_prev is not None:
            dx[:, :hi] += got_prev
        if got_next is not None:
            dx[:, d - lo:] += got_next
        return dx, None, None, None


def copy_to_model(x: torch.Tensor, shard: VolumeShard) -> torch.Tensor:
    """`x` as it is; its gradient summed over the model group."""
    return _CopyToModel.apply(x, shard)


def gather_planes(x: torch.Tensor, shard: VolumeShard,
                  sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(B, d, ...) -> (B, sum of sizes, ...): every model rank's slice of
    a tensor split along dim 1, in rank order; `sizes` gives each rank's
    length there (all d by default). Its backward is this rank's slice of
    the gradient."""
    sizes: List[int] = list(sizes) if sizes is not None \
        else [x.shape[1]] * shard.n
    if len(sizes) != shard.n or x.shape[1] != sizes[shard.rank]:
        raise ValueError(f"gather_planes: sizes {sizes} for a slice of "
                         f"{x.shape[1]} on model rank {shard.rank}")
    return _GatherPlanes.apply(x, shard, sizes)


def halo_exchange(x: torch.Tensor, shard: VolumeShard, lo: int,
                  hi: int) -> torch.Tensor:
    """(B, d, ...) -> (B, lo + d + hi, ...): this rank's planes with `lo`
    planes of the previous model rank and `hi` of the next around them,
    zero planes past the volume's ends."""
    return _HaloExchange.apply(x, shard, lo, hi)
