"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result's line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names the loop that sends its
requests; each metric is read by the file of its name.  ``run_cell`` is
the whole run on any device (the tests rehearse it on the CPU at tiny
sizes); ``main`` is the command, which runs only on CUDA devices.
"""

from __future__ import annotations

import array
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

from portbench import check, files
from portbench import trace as tracing
from portbench.readings import Request, Run

FORBIDDEN = ("jax", "jaxlib", "flax", "mpx")


class NoDevice(RuntimeError):
    pass


class Cell:
    """What a loop sees of the run: the configuration and traffic as
    loaded, the seed, the device, and where to record requests and
    counters."""

    def __init__(self, root, workload, config, traffic, seed, device, trace):
        self.root, self.workload = root, workload
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.m, self.dtype = int(config["m"]), config["dtype"]
        self.counters: dict = {}
        # The window's requests, in flat arrays that the garbage collector
        # does not walk: the harness's bookkeeping adds no pauses.
        self._kinds: list = []
        self._times = array.array("d")
        self._sizes = array.array("q")

    def record(self, kind: str, t0: float, t1: float, n: int, pairs: int = 0):
        if not self._kinds or self._kinds[-1][0] != kind:
            self._kinds.append((kind, len(self._times) // 2))
        self._times.extend((t0, t1))
        self._sizes.extend((n, pairs))

    def requests(self) -> list:
        out = []
        bounds = [start for _, start in self._kinds[1:]] + [len(self._times) // 2]
        for (kind, start), end in zip(self._kinds, bounds):
            for i in range(start, end):
                out.append(Request(kind=kind, t0=self._times[2 * i], t1=self._times[2 * i + 1],
                                   n=self._sizes[2 * i], m=self.m, dtype=self.dtype,
                                   pairs=self._sizes[2 * i + 1]))
        return out

    def span(self, name: str):
        return tracing.span(name) if self.trace else contextlib.nullcontext()


def load_cell(root: str, workload: str, overrides: dict | None = None):
    """(benchmark, cell entry, configuration, traffic) for ``workload``;
    ``overrides`` = {"config": {...}, "traffic": {...}} replaces keys (the
    tests' tiny sizes, the control's precision)."""
    bench = files.benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = files.load_json(os.path.join(root, entry["file"]))
    traffic = files.load_json(files.path(root, "traffic", cell["traffic"], ".json"))
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return bench, cell, config, traffic


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell's line carries: with ``trace`` the per-layer
    ones, else the end-to-end ones; each only in the cells its
    ``workloads`` lists, and a per-layer one without that key in every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m["workloads"] or ("workloads" not in m and m["moves"] in mine)]


def device_info(cell_chips: int, cuda: bool) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell_chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(cell_chips)))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def require_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")


def import_program(root: str):
    """``mpx_torch`` from this checkout, and no other copy."""
    import mpx_torch

    where = os.path.realpath(os.path.dirname(mpx_torch.__file__))
    if where != os.path.realpath(os.path.join(root, "mpx_torch")):
        raise ImportError(f"mpx_torch was imported from {where}, not from the checkout {root}")
    return mpx_torch


def forbidden_modules() -> list:
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """One whole run; returns the result's line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, entry, config, traffic = load_cell(root, workload, overrides)
    cuda = device.startswith("cuda")
    import torch

    if cuda:
        require_device(int(entry["chips"]))
    import_program(root)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    loop = files.module(root, "loops", traffic["loop"])
    cell = Cell(root, workload, config, traffic, seed, device, trace)
    state = loop.setup(cell)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    length = seconds
    if trace and traffic.get("trace_seconds"):
        length = min(seconds, float(traffic["trace_seconds"]))
    # What set-up made stays out of the collector's scans in the window.
    gc.collect()
    gc.freeze()
    with tracing.window(trace, cuda) as traced:
        t0 = time.perf_counter()
        loop.window(cell, state, t0 + length)
        t1 = time.perf_counter()
    gc.unfreeze()
    done = cell.requests()
    dev = device_info(int(entry["chips"]), cuda)
    kept = loop.finish(cell, state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    tally = loop.check(cell, state, kept)
    check_s = time.perf_counter() - t_check
    correct, numbers = check.verdict(tally, config, with_reads=tally.reads > 0)
    run = Run(workload=workload, config=config, traffic=traffic, setup_s=setup_s,
              window=(t0, t1), requests=done, trace=traced.trace,
              counters=cell.counters)
    metrics = {}
    for m in metric_entries(bench, workload, trace):
        value = files.module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced.trace is not None:
        dev["busy_s"] = traced.trace.busy_s
        dev["window_s"] = traced.trace.window_s
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": tally.answers_wrong, "metrics": metrics, "device": dev}
    if traced.trace is not None:
        result["breakdown"] = {"device_ops": traced.trace.device_ops,
                               "idle_gaps": traced.trace.idle_gaps}
    ms = sorted((r.t1 - r.t0) * 1e3 for r in done)
    result["counters"] = dict(cell.counters, answers_compared=tally.answers,
                              window_s=t1 - t0, check_s=check_s,
                              first_ms=(done[0].t1 - done[0].t0) * 1e3 if done else None,
                              median_ms=ms[len(ms) // 2] if ms else None,
                              max_ms=ms[-1] if ms else None)
    result["checks"] = numbers
    return result


def check_lines(result: dict) -> list:
    out = []
    for name, v in result["checks"].items():
        rel = "at least" if name == "rows" else "limit"
        out.append(f"{name} {v['value']!r} {rel} {v['limit']!r}")
    return out


def main(args, t_start: float) -> int:
    root = files.ROOT
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
