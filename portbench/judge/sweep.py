"""`correct` of a PGD sweep, for any detector (an adapter module names
what differs: its reference, how a batch's clean frames, gt and loss are
made, the attack's step and ball, and what a PNG must hold).

What the timed path produced, for a sample of the window's batches drawn
from the seed: the loss of every iteration (`attack.pgd.pgd_attack`'s
result), the packed gradient signs that the host replays (as
`data.dataset.fetch_packed_signs` hands them over) and every PNG written.

The reference follows the program's trajectory: the program's iterate k
is the clean frame plus its own signs of iterations 1..k, replayed here
by the update rule, exact in float32 as on the card, so it needs nothing
else of the program's state. Then:
- `png_px_off`: bytes of every written PNG (iterations 0..K, both views)
  that differ from what the replayed iterate must give; iteration 0 is
  the traffic's own frame. Exact: limit 0.
- `top1_disagree.median`: for each pair, view and iteration, the share
  of the 1% largest |g| of the float32 reference's gradient g at the
  same iterate where the program's sign differs; the median over the
  sample. These entries carry most of a sign step's first-order gain.
  Not the mean of `ascent_lost` (the share of that gain the program's
  signs lose, (sum |g| - sum s g) / (2 sum |g|)): where a loss's discrete
  choices (top-k proposals, NMS, ROI sampling) fall otherwise in
  bfloat16 than in float32, it doubles on some seeds, in the plain
  reference computed in bfloat16 as in the program.
Other readings are printed beside them and decide nothing: the mean and
largest of each, `ascent_lost`, the plain share of differing signs, that
share among the 10% largest |g|, and `loss_rel_gap` (the relative gap
between the program's loss of an iteration and the reference's at the
same iterate), which the float8 control does not separate from the
program's: with seeded weights the loss is mostly the class bias's focal
term.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import threading

import numpy as np
import torch

from portbench import frames, png, weights
from portbench.judge import kept_batches as sample_of
from portbench.judge import signs as S

READINGS = ("sign_disagree", "ascent_lost", "top10_disagree",
            "top1_disagree", "loss_rel_gap")
NAMES = ("png_px_off", "top1_disagree.median")


def hooks(A, run, patches):
    """Keep the losses and the fetched signs of the kept batches."""
    local = threading.local()
    keep = set(kept_batches(run))

    def keep_losses(orig):
        def call(*a, **k):
            res = orig(*a, **k)
            if run.batches[-1]["index"] in keep:
                run.losses.append((run.batches[-1]["index"], res.losses))
            return res
        return call

    def keep_signs(orig):
        def call(*a, **k):
            out = orig(*a, **k)
            local.signs = out
            return out
        return call

    def tag_signs(orig):
        def call(batch, *a, **k):
            got = getattr(local, "signs", None)
            local.signs = None
            ids = tuple(batch["frame_ids"])
            if got is not None and any(
                    b["index"] in keep and tuple(b["ids"]) == ids
                    for b in run.batches[-8:]):
                run.signs[ids] = got
            return orig(batch, *a, **k)
        return call

    patches.wrap("eval_driving_safety_tpu_torch.attack.pgd:pgd_attack",
                 keep_losses)
    patches.wrap("eval_driving_safety_tpu_torch.data.dataset:"
                 "fetch_packed_signs", keep_signs)
    patches.wrap("eval_driving_safety_tpu_torch.data.dataset:save_sweep",
                 tag_signs)


def kept_batches(run) -> list:
    return sample_of(run, 1)


def sample(run) -> list:
    """The kept batches that the window started and whose outputs all
    landed (an answer that lands after the window's close is late, not
    wrong: the harness waits for every one)."""
    kept = set(kept_batches(run))
    return [b for b in run.window_batches() if b["index"] in kept
            and all(i in run.done for i in b["ids"])
            and tuple(b["ids"]) in run.signs]


def limit(run, name):
    return run.cell.limits.get(name, {}).get("limit", -1)


def reference_model(A, config, ckpt, device, cast=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    kw = {} if cast is None else {"cast": cast}
    return A.R.load(config, ckpt, device, **kw)


def readings(A, ref, b, sl, sr, losses, crop) -> dict:
    """The readings of one batch `b` (an adapter's batch) whose iterate k
    is its clean pair plus signs (sl, sr)[:k], against `ref`: per pair,
    view and iteration, lists under each reading's name."""
    xs_l = S.replay(b.clean_l, sl, b.alpha, b.eps, 0.0, b.hi)
    xs_r = S.replay(b.clean_r, sr, b.alpha, b.eps, 0.0, b.hi)
    h, w = crop
    out = {n: [] for n in READINGS}
    for k in range(len(sl)):
        loss, gl, gr = A.loss_and_grad(ref, b, xs_l[k], xs_r[k])
        for g, s in ((gl, sl[k]), (gr, sr[k])):
            for j in range(g.shape[0]):
                for name, v in S.sign_readings(g[j, :h, :w],
                                               s[j, :h, :w]).items():
                    out[name].append(v)
        lr = float(loss)
        out["loss_rel_gap"].append(abs(float(losses[k]) - lr)
                                   / max(abs(lr), 1e-30))
    out["iterates"] = (xs_l, xs_r)
    return out


AGGREGATES = {"max": max, "mean": statistics.fmean,
              "median": statistics.median}


def summary(lists: dict) -> dict:
    """Largest, mean and median of each reading over the sample."""
    return {f"{n}.{agg}": f(v) for n, v in lists.items() if v
            for agg, f in AGGREGATES.items()}


def judge(A, run, device):
    spec = run.cell.traffic
    batches = sample(run)
    if not batches:
        return [{"name": n, "value": float("inf"), "limit": limit(run, n)}
                for n in NAMES]
    ref = reference_model(A, run.cell.config, run.extra["ckpt"], device)
    losses = dict(run.losses)
    tr = run.extra["traffic"]
    px_off, lists = 0, {n: [] for n in READINGS}
    for bt in batches:
        ids = bt["ids"]
        b = A.batch(run.cell, tr, ids, device)
        pl, pr, bits = run.signs[tuple(ids)]
        width = b.clean_l.shape[2]
        sl, sr = (torch.from_numpy(S.unpack(p, bits, width)
                                   .astype(np.float32)).to(device)
                  for p in (pl, pr))
        prog = losses[bt["index"]].float().cpu().numpy()
        got = readings(A, ref, b, sl, sr, prog, b.crop)
        xs_l, xs_r = got.pop("iterates")
        for n, v in got.items():
            lists[n] += v
        for k in range(spec["iters"] + 1):
            for side, xs in (("image_2", xs_l), ("image_3", xs_r)):
                want = A.png_pixels(b, xs[k])
                for j, fid in enumerate(ids):
                    path = os.path.join(run.extra["out"],
                                        f"sweep_iters_{k}", side,
                                        fid + ".png")
                    got_px = png.read(path) if os.path.exists(path) \
                        else None
                    px_off += want[j].size if got_px is None or \
                        got_px.shape != want[j].shape else \
                        int((got_px != want[j]).sum())
    vals = dict(summary(lists), png_px_off=px_off)
    run.extra["readings"] = vals
    return [{"name": n, "value": vals[n], "limit": limit(run, n)}
            for n in NAMES]


def control(A, cell, seed, device, cast, n_batches, batch_size):
    """The control's readings at the cell's sizes: the reference computed
    with `cast` (reference.precision) attacks the first `n_batches`
    batches of the seed's traffic in the program's place, and is held to
    the float32 reference as the program is."""
    iters = cell.traffic["iters"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as d:
        tr = frames.make_traffic(os.path.join(d, "t"), seed,
                                 cell.traffic["frames"])
        sd = weights.make_state_dict(A.R.init_shapes_of(cell.config), seed,
                                     device)
        ckpt = os.path.join(d, "w.pt")
        weights.save(sd, ckpt)
        del sd
        ref = reference_model(A, cell.config, ckpt, device)
        low = reference_model(A, cell.config, ckpt, device, cast)
        lists = {n_: [] for n_ in READINGS}
        for n in range(n_batches):
            ids = tr.ids[n * batch_size:(n + 1) * batch_size]
            b = A.batch(cell, tr, ids, device)
            sl, sr, losses = [], [], []
            xl, xr = b.clean_l, b.clean_r
            for _ in range(iters):
                loss, gl, gr = A.loss_and_grad(low, b, xl, xr)
                sl.append(torch.sign(gl))
                sr.append(torch.sign(gr))
                losses.append(float(loss))
                xl = S.replay(b.clean_l, [sl[-1]], b.alpha, b.eps, 0.0,
                              b.hi, start=xl)[-1]
                xr = S.replay(b.clean_r, [sr[-1]], b.alpha, b.eps, 0.0,
                              b.hi, start=xr)[-1]
            got = readings(A, ref, b, sl, sr, losses, b.crop)
            got.pop("iterates")
            for n_, v in got.items():
                lists[n_] += v
        return summary(lists)
