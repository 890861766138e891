"""One run of one cell: make the traffic and the weights from the seed,
drive the port's CLI in this process through a warm-up and a measured
window, judge what the window produced against the plain reference, and
print the result line.

The CLI is the entry the window drives, unchanged; the harness only
wraps calls into the port's layers from the outside:
- `KittiStereoDataset.batches`: the window's clock. The first
  `warmup_batches` batches warm every shape up; the harness waits until
  their outputs are on disk, and the window opens when the CLI asks for
  the next batch. Once `--seconds` have passed the generator ends, so
  the CLI finishes what it has in flight and returns. The time the CLI
  waits in it is the loader's wait.
- the function that writes each output (`data.kitti.save_image` for the
  sweeps' PNGs): the time every output lands, from which the rate counts
  the pairs whose outputs all landed inside the window.
- the functions the traffic file lists under `spans`: host intervals.
- what the judge needs of the timed path's products (losses, signs).
With `--trace 1` the profiler records `trace_batches` batches of the
window, from its third, and the metric files may wrap more (a range
around a kernel's calls).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

PB = Path(__file__).resolve().parent
ROOT = PB.parent
PORT = "eval_driving_safety_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "eval_driving_safety_tpu")
TRACE_SKIP = 2          # window batches before the profiler starts


class RunError(RuntimeError):
    pass


# ----------------------------------------------------------------- files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files read."""
    name: str
    chips: int
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<traffic>.json
    limits: dict                 # limits/<cell>.json ({} until set)
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json, built from its files alone."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(work)}")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / confs[w["config"]]["file"])
    traffic = load_json(PB / "traffic" / f"{w['traffic']}.json")
    lpath = PB / "limits" / f"{name}.json"
    limits = load_json(lpath) if lpath.exists() else {}

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in reported]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def metric_module(name: str):
    """portbench/metrics/<name>.py, loaded by its path (names hold dots)."""
    path = PB / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(cell: Cell):
    """portbench/reference/<config's reference>.py"""
    return importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")


def judge_of(cell: Cell):
    """(judge, adapter): portbench/judge/<traffic's check>.py, which
    decides `correct` for any model, and the model's adapter to it,
    portbench/judge/<reference>_<check>.py, which its functions take."""
    check = cell.traffic["check"]
    return (importlib.import_module(f"portbench.judge.{check}"),
            importlib.import_module(
                f"portbench.judge.{cell.config['reference']}_{check}"))


def resolve(ref: str):
    """'package.module:attr' -> (module, attr name)."""
    mod, attr = ref.split(":")
    return importlib.import_module(mod), attr


# ----------------------------------------------------------------- hooks

class Patches:
    """Replace a function of the port by a wrapper in every loaded port
    module that holds it (call sites that imported it by name
    included), and put everything back at the end."""

    def __init__(self):
        self._undo = []

    def wrap(self, ref: str, make):
        mod, attr = resolve(ref)
        orig = getattr(mod, attr)
        new = make(orig)
        for m in list(sys.modules.values()):
            if m is None or not (getattr(m, "__name__", "") or "") \
                    .startswith(PORT):
                continue
            for k, v in list(vars(m).items()):
                if v is orig:
                    self._undo.append((m, k, v))
                    setattr(m, k, new)
        return orig

    def set(self, obj, attr, value):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore(self):
        for m, k, v in reversed(self._undo):
            setattr(m, k, v)
        self._undo.clear()


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    thread: str
    ids: tuple                           # frame ids of a batch argument


@dataclass
class Run:
    """What one run recorded; the metric readers read it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_proc: float
    t0: float = 0.0                      # window, perf_counter seconds
    t1: float = 0.0
    batches: List[dict] = field(default_factory=list)
    done: Dict[str, float] = field(default_factory=dict)   # id -> time
    outputs: Dict[str, int] = field(default_factory=dict)  # id -> count
    out_times: List[float] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    losses: List = field(default_factory=list)             # per batch
    signs: Dict[tuple, tuple] = field(default_factory=dict)
    dtc_calls: List[tuple] = field(default_factory=list)
    profiling: bool = False
    trace_data: object = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    extra: dict = field(default_factory=dict)

    # -- what the readers use
    def window_batches(self):
        return [b for b in self.batches if b["window"]]

    def pairs_in_window(self) -> int:
        return sum(len(b["ids"]) for b in self.window_batches())

    def completed_in_window(self) -> List[str]:
        return [i for b in self.window_batches() for i in b["ids"]
                if self.t0 <= self.done.get(i, float("inf")) <= self.t1]

    def units_in_window(self) -> float:
        """Work completed inside the window: the outputs that landed in
        it over the outputs a unit of work makes (a sweep's pair writes
        2 x (iterations + 1) PNGs; a patch step is one)."""
        return self.units_between(self.t0, self.t1)

    def units_between(self, t0: float, t1: float) -> float:
        n = sum(1 for t in self.out_times if t0 <= t <= t1)
        return n / self.cell.traffic["outputs_per_unit"]

    def span_seconds(self, name: str) -> float:
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and self.t0 <= s.t0 <= self.t1)

    def span_pairs(self, name: str) -> int:
        """Distinct frames whose batch a `name` span took, over the spans
        that started in the window."""
        return len({i for s in self.spans
                    if s.name == name and self.t0 <= s.t0 <= self.t1
                    for i in s.ids})


def _ids_of(args) -> tuple:
    for a in args:
        if isinstance(a, dict) and "frame_ids" in a:
            return tuple(a["frame_ids"])
    return ()


def install(run: Run, patches: Patches, spec: dict):
    """The hooks every run of the cell needs (see the module's doc)."""
    from eval_driving_safety_tpu_torch.data import dataset as D
    cuda = run.device == "cuda"
    warm = spec["warmup_batches"]
    per_unit = spec["outputs_per_unit"]
    by_batch = spec["output"] == "batch"
    trace_from = warm + TRACE_SKIP
    trace_to = trace_from + spec["trace_batches"]
    orig_batches = D.KittiStereoDataset.batches

    def sync():
        if cuda:
            import torch
            torch.cuda.synchronize()

    def wait_outputs(ids, limit_s=300.0):
        t_end = time.perf_counter() + limit_s
        while any(i not in run.done for i in ids):
            if time.perf_counter() > t_end:
                raise RunError(f"the warm-up's outputs of {ids} did not "
                               f"land in {limit_s} s")
            time.sleep(0.002)

    def batches(ds, batch_size, *a, **k):
        gen = orig_batches(ds, batch_size, *a, **k)
        i = 0
        try:
            while True:
                if i == 0:
                    run.extra["setup_marks"]["cli_to_first_batch"] = \
                        time.perf_counter()
                elif by_batch:
                    batch_done(run.batches[-1], spec["outputs_per_batch"])
                if i == warm:
                    wait_outputs([x for b in run.batches for x in b["ids"]])
                    sync()
                    run.t0 = time.perf_counter()
                    run.t1 = run.t0 + run.seconds
                elif i > warm and time.perf_counter() >= run.t1:
                    return
                if run.trace and i == trace_from:
                    start_profiler(run)
                elif run.trace and i == trace_to:
                    stop_profiler(run)
                    run.extra["traced_batches"] = i - trace_from
                    run.extra["untraced_from"] = time.perf_counter()
                t = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    raise RunError("the split ran out before the window "
                                   "closed") from None
                t_got = time.perf_counter()
                ids = ds.ids[i * batch_size:(i + 1) * batch_size]
                run.batches.append(dict(index=i, ids=list(ids), start=t,
                                        wait=t_got - t, window=i >= warm))
                yield item
                i += 1
        finally:
            if run.profiling:
                stop_profiler(run)
                run.extra["traced_batches"] = i - trace_from
            gen.close()

    patches.set(D.KittiStereoDataset, "batches", batches)

    def output_writer(orig):
        def write(path, *a, **k):
            out = orig(path, *a, **k)
            t = time.perf_counter()
            fid = os.path.splitext(os.path.basename(path))[0]
            with run.lock:
                run.out_times.append(t)
                n = run.outputs.get(fid, 0) + 1
                run.outputs[fid] = n
                if n == per_unit:
                    run.done[fid] = t
            return out
        return write

    def batch_done(b, n):
        t = time.perf_counter()
        with run.lock:
            run.out_times += [t] * n
            for fid in b["ids"]:
                run.done[fid] = t

    if not by_batch:
        patches.wrap(spec["output"], output_writer)

    for name, refs in spec.get("spans", {}).items():
        for ref in refs:
            def make(orig, name=name):
                def timed(*a, **k):
                    t = time.perf_counter()
                    try:
                        return orig(*a, **k)
                    finally:
                        run.spans.append(Span(
                            name, t, time.perf_counter(),
                            threading.current_thread().name, _ids_of(a)))
                return timed
            patches.wrap(ref, make)


def start_profiler(run: Run):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    run.extra["prof"] = prof
    run.extra["win"] = torch.ops.profiler._record_function_enter_new(
        "portbench.traced_window", None)
    run.profiling = True


def stop_profiler(run: Run):
    import torch
    torch.cuda.synchronize()
    run.profiling = False
    torch.ops.profiler._record_function_exit._RecordFunction(
        run.extra.pop("win"))
    prof = run.extra.pop("prof")
    prof.stop()
    run.extra["profile"] = prof


# ------------------------------------------------------------------ a run

def cli_argv(cell: Cell, tr, ckpt: str, out: str, device: str,
             seed: int = 0) -> List[str]:
    t = cell.traffic
    fill = dict(data=tr.root, split=tr.split, ckpt=ckpt, out=out,
                seed=seed)
    argv = [a.format(**fill) for a in t["args"]]
    argv += [a.format(**fill) for a in cell.config["cli_args"][t["cli"]]]
    if device != "cuda":
        argv += ["--device", device]
    return argv


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
          t_proc: float, workdir: str) -> Run:
    """Make the traffic and weights, run the CLI through its window, and
    return what it recorded."""
    import torch
    from portbench import frames, weights
    run = Run(cell, seed, seconds, trace, device, t_proc)
    spec = cell.traffic
    marks = run.extra.setdefault("setup_marks", {})
    if device == "cuda":
        torch.cuda.init()
    marks["cuda_init"] = time.perf_counter()
    tr = frames.make_traffic(os.path.join(workdir, "traffic"), seed,
                             spec["frames"])
    marks["traffic"] = time.perf_counter()
    ref = reference_module(cell)
    sd = weights.make_state_dict(ref.init_shapes_of(cell.config), seed,
                                 device)
    ckpt = os.path.join(workdir, "weights.pt")
    run.extra["weights_bytes"] = weights.save(sd, ckpt)
    del sd
    marks["weights"] = time.perf_counter()
    out = os.path.join(workdir, "out")
    os.makedirs(out, exist_ok=True)
    main = importlib.import_module(spec["module"]).main
    patches = Patches()
    judge, adapter = judge_of(cell)
    try:
        install(run, patches, spec)
        judge.hooks(adapter, run, patches)
        if trace:
            for m in cell.per_layer:
                hook = getattr(metric_module(m["name"]), "install", None)
                if hook is not None:
                    hook(run, patches)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            main(cli_argv(cell, tr, ckpt, out, device, seed))
    finally:
        patches.restore()
    run.extra["dropped_bytes"] = drop_unjudged(
        out, tr.ids, spec["batch"], set(judge.kept_batches(run)))
    if run.t0 == 0.0:
        raise RunError("the window never opened: the split is shorter "
                       "than the warm-up")
    run.extra.update(traffic=tr, out=out, ckpt=ckpt)
    if device == "cuda":
        run.extra["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated())
    return run


def drop_unjudged(out: str, ids: List[str], batch: int, kept: set) -> int:
    """Once the window has closed, remove every output named by a frame
    id whose batch the judge does not read, and return their bytes. The
    program wrote each of them inside the window, as a user's job does;
    removing them keeps a check's writes to the machine's disk small."""
    position = {fid: j for j, fid in enumerate(ids)}
    dropped = 0
    for d, _, names in os.walk(out):
        for n in names:
            j = position.get(os.path.splitext(n)[0])
            if j is not None and j // batch not in kept:
                path = os.path.join(d, n)
                dropped += os.path.getsize(path)
                os.remove(path)
    return dropped


def end_to_end(run: Run) -> dict:
    """The cell's end-to-end metrics, each over the whole window."""
    spec = run.cell.traffic
    out = {}
    for m in run.cell.end_to_end:
        if m["name"] == "setup_s":
            v = run.t0 - run.t_proc
        elif m["name"] == spec["rate_metric"]:
            v = run.units_in_window() / run.seconds
        else:
            raise RunError(f"no reading of {m['name']} in this cell")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        v = metric_module(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(run: Run) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.chips,
            "memory_peak_bytes": run.extra.get("memory_peak_bytes", 0)}
    if run.trace_data is not None:
        from portbench import trace as T
        info["busy_s"] = T.busy_s(run.trace_data)
        info["window_s"] = run.trace_data.window_s
    return info


def read_trace(run: Run, workdir: str):
    from portbench import trace as T
    prof = run.extra.pop("profile", None)
    if prof is None:
        raise RunError("the window ended before the traced batches")
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    run.trace_data = T.load(path)
    os.remove(path)


def breakdown(run: Run) -> dict:
    from portbench import trace as T
    return {"device_ops": T.top_device_ops(run.trace_data),
            "idle_gaps": T.idle_gaps(run.trace_data)}


def power_limit() -> str:
    try:
        import subprocess
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def files_bytes(root: str) -> int:
    """Bytes of the files under `root` (hard links once): what the run
    wrote there, the traffic, the weights and every output."""
    seen, total = set(), 0
    for d, _, names in os.walk(root):
        for n in names:
            st = os.lstat(os.path.join(d, n))
            if st.st_ino not in seen:
                seen.add(st.st_ino)
                total += st.st_size
    return total


def measure(cell: Cell, seed: int, seconds: float, trace: bool,
            t_proc: float, device: str = "cuda") -> dict:
    """One whole run: returns the result object (and its comparisons
    under "checks")."""
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = drive(cell, seed, seconds, trace, device, t_proc, workdir)
        result = {"correct": False,
                  "attempted": run.pairs_in_window(),
                  "failed": sum(1 for b in run.window_batches()
                                for i in b["ids"] if i not in run.done)}
        if trace:
            read_trace(run, workdir)
            metrics = per_layer(run)
        else:
            metrics = end_to_end(run)
        info = {"seed": seed, "window_s": run.seconds,
                "units_in_window": run.units_in_window(),
                "batches_in_window": len(run.window_batches()),
                "pairs_completed": len(run.completed_in_window()),
                "memory_peak_bytes": run.extra.get("memory_peak_bytes"),
                "weights_bytes": run.extra.get("weights_bytes"),
                "bytes_written": files_bytes(workdir)
                + run.extra.get("dropped_bytes", 0),
                "power": power_limit() if device == "cuda" else "cpu"}
        dev = device_info(run) if device == "cuda" else {
            "platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
        bd = breakdown(run) if trace else None
        del_program_state()
        judge, adapter = judge_of(cell)
        checks = judge.judge(adapter, run, device)
        ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks) \
            and result["attempted"] > 0 and result["failed"] == 0 \
            and run.units_in_window() > 0
        result.update(correct=ok, metrics=metrics, device=dev)
        if bd is not None:
            result["breakdown"] = bd
        result["checks"] = {c["name"]: {"value": c["value"],
                                        "limit": c["limit"]}
                            for c in checks}
        info["readings"] = run.extra.get("readings")
        info["setup_s"] = setup_breakdown(run)
        result["info"] = info
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def setup_breakdown(run: Run) -> dict:
    """Seconds of set-up by stage: process start to the card's
    initialisation (imports included), the traffic, the weights file,
    the CLI's start to its first batch (model build, loader), and the
    warm-up batches until the window opens."""
    m = run.extra.get("setup_marks", {})
    order = [("start", run.t_proc), ("cuda_init", m.get("cuda_init")),
             ("traffic", m.get("traffic")), ("weights", m.get("weights")),
             ("cli_to_first_batch", m.get("cli_to_first_batch")),
             ("warmup", run.t0)]
    out, prev = {}, None
    for name, t in order:
        if t is not None and prev is not None:
            out[name] = t - prev
        prev = t if t is not None else prev
    return out


def del_program_state():
    gc.collect()
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass
