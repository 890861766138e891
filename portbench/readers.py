"""The arithmetic of the per-layer metrics. Each metric's file under
metrics/ names its layer, unit and the end-to-end metric it moves, and
takes its `read` (and, where it wraps a call, its `install`) from here.
A reader that finds nothing to read returns None, and the metric is left
out of the line."""
from __future__ import annotations

import importlib

import torch

from portbench import counts
from portbench import trace as T


def loader_wait_ms(run):
    """Host ms per window batch that the CLI's loop waited in
    `KittiStereoDataset.batches` for its next batch."""
    bs = run.window_batches()
    return sum(b["wait"] for b in bs) / len(bs) * 1e3 if bs else None


def span_ms_per_pair(name):
    """Host ms per pair in the traffic's `spans[name]` functions, over the
    calls that started inside the window: per pair of the calls that took
    a batch (a dict with `frame_ids`), or else per pair of the window's
    batches."""
    def read(run):
        pairs = run.span_pairs(name) or run.pairs_in_window()
        return run.span_seconds(name) / pairs * 1e3 if pairs else None
    return read


def device_idle_pct(run):
    tr = run.trace_data
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - T.busy_s(tr) / tr.window_s)


def mfu(kind):
    """The model's operations per unit of work (counted once on the plain
    reference at the cell's shapes, on the meta device) times the units
    completed in the window once the profiler had stopped, over that part
    of the window and the dtype's peak: the profiler's own host cost
    slows the traced batches, and is left out."""
    def read(run):
        t0 = run.extra.get("untraced_from")
        if t0 is None or run.t1 - t0 <= 0:
            return None
        units = run.units_between(t0, run.t1)
        if not units:
            return None
        ref = importlib.import_module(
            f"portbench.reference.{run.cell.config['reference']}")
        ops = ref.flops_per_unit(run.cell.config, run.cell.traffic, kind)
        peak = counts.PEAK_OPS[run.cell.config["dtype"]]
        return 100.0 * ops * units / (run.t1 - t0) / peak
    return read


# ------------------------------------------------- the depth-tap conv

FWD, BWD = "portbench.depth_tap_conv.fwd", "portbench.depth_tap_conv.bwd"


class _Open(torch.autograd.Function):
    """Identity on the op's output; its backward runs first of the op's
    backward and opens the backward range."""

    @staticmethod
    def forward(ctx, y, holder):
        ctx.holder = holder
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.holder.append(
            torch.ops.profiler._record_function_enter_new(BWD, None))
        return g, None


class _Close(torch.autograd.Function):
    """Identity on the op's input; its backward runs last of the op's
    backward and closes the range."""

    @staticmethod
    def forward(ctx, x, holder):
        ctx.holder = holder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.holder:
            torch.ops.profiler._record_function_exit._RecordFunction(
                ctx.holder.pop())
        return g, None


def mark_depth_tap_conv(run, patches):
    """While the profiler records, put the port's `ops.depthconv.
    depth_tap_conv` calls in a host range (forward) and their autograd
    backward between two identity nodes that open and close another,
    whatever implements them, and record each call's shape."""
    def make(orig):
        def call(x5, w, inv, off, relu=True):
            if not run.profiling:
                return orig(x5, w, inv, off, relu)
            b, d, h, wd, c = x5.shape
            back = x5.requires_grad and torch.is_grad_enabled()
            run.dtc_calls.append(((b, d, h * wd, c, w.shape[-1]),
                                  str(x5.dtype).removeprefix("torch."),
                                  back))
            holder = []
            if back:
                x5 = _Close.apply(x5, holder)
            with torch.profiler.record_function(FWD):
                y = orig(x5, w, inv, off, relu)
            return _Open.apply(y, holder) if back else y
        return call
    patches.wrap("eval_driving_safety_tpu_torch.ops.depthconv:"
                 "depth_tap_conv", make)


def depth_tap_conv_roofline(run):
    """The calls' summed bound (bytes at the memory's peak or operations
    at the dtype's, per call, from the copied per-shape counts) over the
    device time of every kernel launched inside their ranges."""
    tr = run.trace_data
    if tr is None or not run.dtc_calls:
        return None
    dev = T.device_s_under(tr, (FWD, BWD))
    if dev <= 0:
        return None
    return 100.0 * counts.depth_tap_conv_bound_s(run.dtc_calls) / dev


def roi_align_ms_per_iter(run):
    """Device ms a PGD iteration under the port's `roi_align_fwd` /
    `roi_align_bwd` ranges."""
    tr = run.trace_data
    iters = run.extra.get("traced_batches", 0) * run.cell.traffic["iters"]
    if tr is None or not iters:
        return None
    dev = T.device_s_under(tr, ("roi_align_fwd", "roi_align_bwd"))
    return dev / iters * 1e3 if dev > 0 else None
