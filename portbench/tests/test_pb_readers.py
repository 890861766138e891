"""The per-layer readers' arithmetic on a canned profiler trace and a
canned span log."""
import types

import pytest

from portbench import harness, readers
from portbench import trace as T


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


CANNED = [
    ev("user_annotation", "portbench.traced_window", 100, 1000),
    # a forward range launching kernels 1 and 2, a backward range on the
    # autograd thread launching kernel 3, and kernel 4 outside any range
    ev("user_annotation", readers.FWD, 110, 50),
    ev("cuda_runtime", "cudaLaunchKernel", 115, 5, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=2),
    ev("user_annotation", readers.BWD, 300, 40, tid=2),
    ev("cuda_driver", "cuLaunchKernel", 310, 5, tid=2, corr=3),
    ev("cpu_op", "aten::add", 400, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 405, 5, corr=4),
    ev("cpu_op", "aten::item", 700, 300),
    ev("kernel", "k1", 200, 100, tid=7, corr=1),
    ev("kernel", "k2", 250, 150, tid=7, corr=2),     # overlaps k1
    ev("kernel", "k3", 450, 50, tid=7, corr=3),
    ev("kernel", "k4", 1050, 100, tid=7, corr=4),    # half past the window
    ev("gpu_memcpy", "Memcpy DtoH", 600, 10, tid=7),
]


@pytest.fixture
def tr():
    return T.reduce_events(CANNED)


def test_busy_and_idle(tr):
    # busy: [200, 400) + [450, 500) + [600, 610) + [1050, 1100) = 310 us
    assert T.busy_s(tr) == pytest.approx(310e-6)
    assert tr.window_s == pytest.approx(1000e-6)
    run = types.SimpleNamespace(trace_data=tr)
    assert readers.device_idle_pct(run) == pytest.approx(69.0)


def test_device_time_under_ranges(tr):
    # k1 + k2 under the forward range, k3 under the backward range
    assert T.device_s_under(tr, (readers.FWD,)) == pytest.approx(250e-6)
    assert T.device_s_under(tr, (readers.BWD,)) == pytest.approx(50e-6)
    assert T.device_s_under(tr, ("nothing",)) == 0.0


def test_top_ops_and_idle_gaps(tr):
    ops = dict(T.top_device_ops(tr))
    assert ops["k2"] == pytest.approx(150e-6)
    assert ops["k4"] == pytest.approx(50e-6)
    gaps = dict(T.idle_gaps(tr))
    # gaps: [100,200) python, [400,450) starts in aten::add, [500,600)
    # python, [610,1050) starts before aten::item opens: python
    assert gaps["aten::add"] == pytest.approx(50e-6)
    assert gaps["python"] == pytest.approx(640e-6)


def test_roofline_reader(tr):
    shape = (1, 96, 29952, 32, 32)
    run = types.SimpleNamespace(trace_data=tr,
                                dtc_calls=[(shape, "bfloat16", True)])
    bound = readers.counts.depth_tap_conv_bound_s(run.dtc_calls)
    assert readers.depth_tap_conv_roofline(run) == pytest.approx(
        100 * bound / 300e-6)


def span_run():
    cell = types.SimpleNamespace(traffic={"outputs_per_unit": 10,
                                          "iters": 4})
    run = harness.Run(cell, 1, 10.0, False, "cpu", 0.0)
    run.t0, run.t1 = 100.0, 110.0
    run.batches = [dict(index=0, ids=["a", "b"], start=95, wait=0.5,
                        window=False),
                   dict(index=1, ids=["c", "d"], start=101, wait=0.002,
                        window=True),
                   dict(index=2, ids=["e", "f"], start=105, wait=0.004,
                        window=True)]
    run.spans = [harness.Span("replay_write", 99.0, 99.5, "t", ("a", "b")),
                 harness.Span("replay_write", 102.0, 102.03, "t", ("c", "d")),
                 harness.Span("replay_write", 102.03, 102.06, "t",
                              ("c", "d")),
                 harness.Span("replay_write", 106.0, 106.1, "t", ("e", "f"))]
    run.out_times = [99.9] * 20 + [103.0] * 20 + [108.0] * 15 + [111.0] * 5
    return run


def test_span_log_readers():
    run = span_run()
    assert readers.loader_wait_ms(run) == pytest.approx(3.0)
    assert readers.span_ms_per_pair("replay_write")(run) == pytest.approx(
        (0.06 + 0.1) / 4 * 1e3)
    # 35 of the outputs landed inside the window: 3.5 pairs
    assert run.units_in_window() == pytest.approx(3.5)


def test_mfu_reads_the_part_of_the_window_after_the_profiler(monkeypatch):
    run = span_run()
    run.cell.config = {"reference": "stub", "dtype": "bfloat16"}
    stub = types.SimpleNamespace(
        flops_per_unit=lambda config, traffic, kind: 1e12)
    monkeypatch.setattr(readers.importlib, "import_module",
                        lambda name: stub)
    assert readers.mfu("attack")(run) is None        # never traced
    run.extra["untraced_from"] = 104.0
    # 15 outputs landed in [104, 110]: 1.5 pairs in 6 s at 1 TFLOP a pair
    peak = readers.counts.PEAK_OPS["bfloat16"]
    assert readers.mfu("attack")(run) == pytest.approx(
        100 * 1e12 * 1.5 / 6.0 / peak)
