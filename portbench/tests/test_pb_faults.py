"""`correct` comes out false when the timed path is broken underneath a
run, and the control (the reference in the precision below the
configuration's) reads past the limits. A whole run of each cell at its
tiny config on the CPU (the harness's look for a card skipped), against
limits set for these sizes, at batch 2 (`TINY_LIMITS`; sound tiny bf16
runs on the CPU read top1_disagree.median 0-0.0022 at batch 8 and the
float8 control 0.0525-0.0645; descent_lost.mean about 0.04)."""
import contextlib
import copy
import dataclasses
import json
import time

import pytest
import torch

from portbench import harness
from portbench.reference.precision import CASTS

TINY_LIMITS = {
    "sweep": {"png_px_off": {"limit": 0}, "top1_disagree.median":
              {"limit": 0.02}},
    "patch": {"box_off": {"limit": 0}, "descent_lost.mean":
              {"limit": 0.12}}}


def tiny_cell(name):
    from eval_driving_safety_tpu_torch.config import (DSGNConfig,
                                                      StereoRCNNConfig)
    c = harness.cell(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    if c.config["reference"] == "dsgn":
        model = DSGNConfig.tiny()
        args, hw = ["--detector", "dsgn", "--scale", "tiny"], (90, 300)
    else:
        model = StereoRCNNConfig.tiny()
        args, hw = ["--detector", "srcnn", "--tiny"], (60, 200)
    m = json.loads(json.dumps(dataclasses.asdict(model)))
    m["dtype"] = c.config["model"]["dtype"]
    if "stem_method" in c.config["model"]:
        m["stem_method"] = c.config["model"]["stem_method"]
    c.config["model"] = m
    c.config["cli_args"] = {c.traffic["cli"]: args}
    c.traffic["frames"].update(height=hw[0], width=hw[1], split_ids=400)
    a = c.traffic["args"] = list(c.traffic["args"])
    a[a.index("--batch") + 1], c.traffic["batch"] = "2", 2
    c.limits = copy.deepcopy(TINY_LIMITS[c.traffic["check"]])
    return c


@pytest.fixture(autouse=True)
def two_of_two(monkeypatch):
    """The judge reads 2 of the window's first 2 batches at these sizes."""
    import portbench.judge as J
    monkeypatch.setattr(J, "SAMPLE_BATCHES", 2)
    monkeypatch.setattr(J, "SAMPLE_WITHIN", 2)


@contextlib.contextmanager
def broken(ref, make):
    """The port's function `ref` replaced by `make(original)` in every
    module that holds it, underneath the harness's own wraps."""
    p = harness.Patches()
    p.wrap(ref, make)
    try:
        yield
    finally:
        p.restore()


PGD = "eval_driving_safety_tpu_torch.attack.pgd:pgd_attack"
SAVE = "eval_driving_safety_tpu_torch.data.kitti:save_image"
STEP = "eval_driving_safety_tpu_torch.attack.patch:patch_update_step"


def still_state(kind):
    """The step returns the state it was given."""
    if kind == "patch":
        return broken(STEP, lambda orig: lambda loss_fn, patch, *a, **k: (
            patch, orig(loss_fn, patch, *a, **k)[1]))

    def make(orig):
        def call(*a, alpha, **k):
            return orig(*a, alpha=alpha * 0, **k)
        return call
    return broken(PGD, make)


def half_batch(kind):
    """Half of the batch is left out: the loss over the first half
    stands for the whole batch."""
    def make(orig):
        def call(loss_fn, *a, **k):
            def half(vl, vr):
                n = vl.shape[0] // 2
                keep = lambda v: torch.cat([v[:n], v[n:].detach()])
                return loss_fn(keep(vl), keep(vr))
            return orig(half, *a, **k)
        return call
    return broken(STEP if kind == "patch" else PGD, make)


def altered_answer(kind):
    """An answer is altered where it is produced: one pixel of every
    iteration-2 PNG, or one value of every patch."""
    if kind == "patch":
        def make(orig):
            def call(*a, **k):
                p, loss = orig(*a, **k)
                p = p.clone()
                p[p.shape[0] // 2, p.shape[1] // 2, 1] += 0.5
                return p, loss
            return call
        return broken(STEP, make)

    def make(orig):
        def call(path, img, *a, **k):
            if "_iters_2" in path:
                img = img.copy()
                img[3, 5, 1] = (int(img[3, 5, 1]) + 7) % 256
            return orig(path, img, *a, **k)
        return call
    return broken(SAVE, make)


CELLS = ("dsgn_full.pgd_sweep", "srcnn_r101.pgd_sweep", "dsgn_full.patch")


def run(cell, seed=2 ** 31 + 99):
    return harness.measure(cell, seed, 12.0, False, time.perf_counter(),
                           device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run(tiny_cell(name))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [still_state, half_batch, altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    kind = cell.traffic["check"]
    with fault(kind):
        r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = tiny_cell(name)
    judge, adapter = harness.judge_of(cell)
    got = judge.control(adapter, cell, 5, "cpu", CASTS["fp8"], 2, 2)
    lim = cell.limits
    assert any(got[n] > lim[n]["limit"] for n in got if n in lim), got
