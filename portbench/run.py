"""One run of one benchmark cell of tpu_pathtracer_torch on the CUDA
device(s) of this machine:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. The cell's entry in BENCHMARK.json names
its configuration (portbench/configs/<config>.json) and its traffic
(portbench/traffic/<traffic>.json, whose `kind` names the driver,
portbench/drivers/<kind>.py). The driver builds the program from the
benchmark's own inputs, warms up every shape the window uses (set-up),
runs the measured window, and then, with the program's state freed,
compares what the window produced with the plain reference
(portbench/reference/) by the numbers and limits of portbench/check.py.

--trace 0 prints the cell's end-to-end metrics; --trace 1 runs the same
window and then a short sub-window under torch.profiler, and prints the
per-layer metrics, each read by its own reader portbench/metrics/<name>.py
(a reader that finds nothing returns None and its metric is left out).

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last `check`: each
compared number with its limit); the numbers compared are also the last
lines of standard error. Without a CUDA device, or with fewer than the
cell asks for, the run prints no result and exits 3; a run that finds
jax, jaxlib, flax or the JAX package tpu_pathtracer loaded once the window
has closed exits 4.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")
WINDOW = "portbench_window"


def process_age():
    """Seconds since this process started (/proc: its start tick against
    the uptime, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Context:
    """What a driver is given, and what it hands back through: the cell's
    configuration and traffic, the run's arguments, the device, and the
    hooks that mark the window's opening and profile a sub-window."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.cache_dir = CACHE
        self.setup_s = None

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_opens(self):
        """Set-up ends here: everything before the first timed call."""
        self.sync()
        self.setup_s = process_age()

    def profile(self, fn):
        """Run fn() under torch.profiler (CPU and CUDA activity) inside the
        record_function WINDOW, ending in a synchronize. Returns (the trace
        events, fn's result); the chrome trace is written under TMPDIR and
        removed once read."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench.metrics._trace import load_events
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            torch.ones(1, device=self.device).add_(1)
            self.sync()
            with record_function(WINDOW):
                out = fn()
                self.sync()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            events = load_events(path)
        finally:
            os.remove(path)
        return events, out

    def free_device(self):
        """Drop what the program left on the device, before the
        reference runs."""
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def read_metric(name, run, root=ROOT):
    """The per-layer metric `name` by its reader portbench/metrics/<name>.py,
    or None."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        os.path.join(root, "portbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cell_setup(bench, cell, overrides=None, root=ROOT):
    """(workload entry, config, traffic) of a cell, each file found by its
    name under the checkout `root`; overrides {"config": {...},
    "traffic": {...}} replace top-level keys (tests run cells at toy sizes
    so)."""
    overrides = overrides or {}
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise SystemExit("run: no cell %r in BENCHMARK.json" % cell)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(root, cfg_entry["file"])
    config.update(overrides.get("config", {}))
    traffic = load_json(root, "portbench", "traffic", wl["traffic"] + ".json")
    traffic.update(overrides.get("traffic", {}))
    return wl, config, traffic


def run_cell(bench, cell, seed, seconds, trace, device, overrides=None,
             root=ROOT):
    """Run one cell on `device` and return the result dict (the line the
    benchmark prints). The CUDA check is main()'s; tests call this on the
    CPU at toy sizes."""
    import torch
    wl, config, traffic = cell_setup(bench, cell, overrides, root)
    driver = importlib.import_module("portbench.drivers." + traffic["kind"])
    ctx = Context(cell, config, traffic, int(seed), float(seconds),
                  bool(trace), torch.device(device))
    out = driver.run(ctx)
    from portbench import check
    correct, shown = check.judge(out["numbers"], check.limits(cell, root))
    correct = correct and out["failed"] == 0
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1,
        "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if trace:
        traced = out["traced"]
        metrics = {}
        for m in bench["per_layer"]:
            if cell not in m.get("workloads", [cell]):
                continue
            v = read_metric(m["name"], traced, root)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        if traced.get("events"):
            from portbench.metrics import _trace
            busy = _trace.device_busy(traced["events"], WINDOW)
            device_info["busy_s"] = busy["busy_ms"] / 1e3
            device_info["window_s"] = busy["window_ms"] / 1e3
            result["breakdown"] = {
                "device_ops": _trace.device_ops_top(traced["events"], WINDOW),
                "idle_gaps": _trace.idle_gaps_top(traced["events"], WINDOW)}
    else:
        metrics = {"setup_s": {"value": ctx.setup_s, "unit": "s"}}
        for name, v in out["metrics"].items():
            metrics[name] = {"value": v, "unit": units[name]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["numbers"] = out["numbers"]
    result["reference_s"] = out["reference_s"]
    result["check"] = shown
    return result


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print("run: no cell %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    spec = importlib.util.find_spec("tpu_pathtracer_torch")
    if spec is None or not os.path.abspath(spec.origin).startswith(
            os.path.abspath(os.getcwd()) + os.sep):
        print("run: tpu_pathtracer_torch is not in this checkout (%s)"
              % os.getcwd(), file=sys.stderr)
        return 2
    # one process with few threads: no OpenMP pool spinning beside the
    # host's share of a step on the machine's shared cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print("run: the cell needs %d CUDA device(s); this machine has %d"
              % (wl["chips"], torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.trace, "cuda:0")
    result["card"] = power_limit()
    found = forbidden_modules()
    if found:
        print("run: loaded after the window: %s" % ", ".join(found),
              file=sys.stderr)
        return 4
    check = result.pop("check")
    print("numbers: " + json.dumps(result["numbers"]), file=sys.stderr)
    for name, (v, lim) in check.items():
        print("check %s %r limit %r" % (name, v, lim), file=sys.stderr)
    result["check"] = check
    # the count beside the metrics (for the drag cell: the steps beside
    # the tail), a line before the result
    print("%s seed %d: %d attempted, %s" % (
        args.workload, args.seed, result["attempted"], ", ".join(
            "%s %.6g %s" % (k, m["value"], m["unit"])
            for k, m in result["metrics"].items())))
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
