"""`correct` of universal-patch training, for any detector (an adapter
module names what differs: its reference, the placements, the composite
and the loss).

What the timed path produced, for a sample of the window's patch steps
drawn from the seed before the run: the patch each step was given and
the patch it returned (`attack.patch.patch_update_step`). The reference
follows the program's state: from the program's patch before a step it
computes the step in float32 (the composite at the placements the CLI
draws for the batch, `cli/patch_attack.py::batch_generator`, redrawn
here from the seed; the loss toward the targeted ghost car; the
gradient through both views; u = clamp(0.5 alpha g, -eps, eps)) and
holds the program's update to it:
- `descent_lost.mean`: 1 - (u_program . g) / (u_reference . g), the
  share of the reference step's first-order descent that the program's
  step loses; 0 for the reference's own step, 1 for no step.
- `box_off`: values of the program's update outside [-eps, eps], or of
  its patch outside the circle's unchanged zero. Exact: limit 0.
"""
from __future__ import annotations

import os
import tempfile

import torch

from portbench import frames, weights
from portbench.judge import kept_batches as sample_of
from portbench.judge.sweep import limit, reference_model, summary

NAMES = ("box_off", "descent_lost.mean")


def kept_batches(run) -> list:
    return sample_of(run, 3)


def hooks(A, run, patches):
    keep = set(kept_batches(run))

    def keep_steps(orig):
        def call(loss_fn, patch, *a, **k):
            out = orig(loss_fn, patch, *a, **k)
            b = run.batches[-1]
            if b["window"] and b["index"] in keep:
                run.extra.setdefault("steps", []).append(
                    (b["index"], patch, out[0], k.get("alpha"), k.get("eps")))
            return out
        return call
    patches.wrap("eval_driving_safety_tpu_torch.attack.patch:"
                 "patch_update_step", keep_steps)


def descent_lost(u_prog, u_ref, g) -> float:
    ref = float((u_ref.double() * g.double()).sum())
    got = float((u_prog.double() * g.double()).sum())
    return 1.0 - got / ref if ref != 0 else 0.0


def judge(A, run, device):
    cfg = A.R.config(run.cell.config["model"])
    tr = run.extra["traffic"]
    steps = run.extra.get("steps", [])
    by_index = {b["index"]: b for b in run.window_batches()}
    steps = [s for s in steps if by_index[s[0]]["ids"][0] in run.done]
    if not steps:
        return [{"name": n, "value": float("inf"), "limit": limit(run, n)}
                for n in NAMES]
    ref = reference_model(A, run.cell.config, run.extra["ckpt"], device)
    lists, off = {"descent_lost": []}, 0
    for index, p_in, p_out, alpha, eps in steps:
        ids = by_index[index]["ids"]
        il, ir = A.images(tr, ids, cfg, device)
        d = p_in.shape[0]
        cl, cr = A.centers(run.seed, index, len(ids), cfg.input.height,
                         cfg.input.width, d // 2)
        p_in, p_out = p_in.float().to(device), p_out.float().to(device)
        g = A.ref_gradient(ref, cfg, il, ir, p_in, cl, cr)
        u_ref = torch.clamp(0.5 * alpha * g, -eps, eps)
        u_prog = p_in - p_out
        lists["descent_lost"].append(descent_lost(u_prog, u_ref, g))
        off += int((u_prog.abs() > eps * (1 + 1e-6)).sum())
        off += int(((1 - A.circle(d, device)) * p_out).abs().gt(0).sum())
    vals = dict(summary(lists), box_off=off)
    run.extra["readings"] = vals
    return [{"name": n, "value": vals[n], "limit": limit(run, n)}
            for n in NAMES]


def control(A, cell, seed, device, cast, n_batches, batch_size):
    """The control's readings: the reference computed with `cast` takes
    the patch steps of the seed's first batches in the program's place
    (from a zero patch), held to the float32 reference as the program
    is."""
    cfg = A.R.config(cell.config["model"])
    a = cell.traffic["patch"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as dd:
        tr = frames.make_traffic(os.path.join(dd, "t"), seed,
                                 cell.traffic["frames"])
        sd = weights.make_state_dict(A.R.init_shapes_of(cell.config), seed,
                                     device)
        ckpt = os.path.join(dd, "w.pt")
        weights.save(sd, ckpt)
        ref = reference_model(A, cell.config, ckpt, device)
        low = reference_model(A, cell.config, ckpt, device, cast)
        d = int(cfg.height * a["ratio"])
        d = d + 1 if d % 2 == 0 else d
        patch = torch.zeros(d, d, 3, device=device)
        lists = {"descent_lost": []}
        for n in range(n_batches):
            ids = tr.ids[n * batch_size:(n + 1) * batch_size]
            il, ir = A.images(tr, ids, cfg, device)
            cl, cr = A.centers(seed, n, len(ids), cfg.input.height,
                             cfg.input.width, d // 2)
            for _ in range(a["iters"]):
                g_low = A.ref_gradient(low, cfg, il, ir, patch, cl, cr)
                u_low = torch.clamp(0.5 * a["alpha"] * g_low, -a["eps"],
                                    a["eps"])
                g = A.ref_gradient(ref, cfg, il, ir, patch, cl, cr)
                u_ref = torch.clamp(0.5 * a["alpha"] * g, -a["eps"],
                                    a["eps"])
                lists["descent_lost"].append(descent_lost(u_low, u_ref, g))
                patch = patch - u_low
        return summary(lists)
