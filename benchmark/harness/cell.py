"""One run of one cell: the manifest's entry, its configuration and its
traffic mix found by name, the mix's driver run, the metrics read by
their readers, and the outputs checked against the plain reference.

Nothing here is particular to a cell: a configuration is
``configs/<file>.json`` (as the manifest names it), a mix is
``traffic/<name>.json`` whose ``driver`` names a module of this package,
and a metric is ``metrics/<name>.py`` with ``read(rec) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import threading
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names the measured process must not hold: the JAX
# package and JAX itself. Compared whole (brpc_tpu_torch is the port).
FORBIDDEN = ("jax", "jaxlib", "flax", "brpc_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a forbidden import)."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class MemorySampler:
    """The card's used memory, all processes on it, sampled every 0.2 s
    (``cudaMemGetInfo``); its peak over the run."""

    def __init__(self):
        import torch

        self._torch = torch
        self._stop = threading.Event()
        self.peak = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        free, total = self._torch.cuda.mem_get_info()
        self.peak = max(self.peak, total - free)

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            self._sample()

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self._sample()
        return self.peak


class Ctx:
    """What a driver sees of the run."""

    process_timeout_s = 900.0

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, rehearse: bool = False, t_start: float = None,
                 bench: dict = None):
        import torch

        self.t_start = time.monotonic() if t_start is None else t_start
        self.bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        conf = {c["name"]: c for c in self.bench["configs"]}[
            self.cell["config"]]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.mix = load_json(os.path.join(BENCH_DIR, "traffic",
                                          self.cell["traffic"] + ".json"))
        self.model = dict(self.config["model"])
        if rehearse:
            self.model.update(self.config["rehearse"])
        self.optimizer = self.config["optimizer"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.rehearse = rehearse
        self.cuda = not rehearse
        if self.cuda:
            if not torch.cuda.is_available():
                raise RunError("no CUDA card (torch.cuda.is_available() is "
                               "false); --rehearse runs on the CPU")
            if torch.cuda.device_count() < self.cell["chips"]:
                raise RunError(f"{self.cell['name']} needs "
                               f"{self.cell['chips']} cards, "
                               f"{torch.cuda.device_count()} visible")
            self.device = torch.device("cuda", 0)
            torch.cuda.set_device(self.device)
            self.kind = torch.cuda.get_device_name(self.device)
        else:
            self.device = torch.device("cpu")
            self.kind = "CPU rehearsal: these numbers describe no card"
        self._excluded = 0.0
        self.t_open = None
        self.memory_peak = None
        self._sampler = MemorySampler() if self.cuda else None

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def sync_stream(self) -> None:
        """Wait for the calling thread's current stream."""
        if self.cuda:
            import torch

            torch.cuda.current_stream(self.device).synchronize()

    def exclude_from_setup(self, seconds: float) -> None:
        """Set-up time spent on the check's own reads."""
        self._excluded += seconds

    def open_window(self) -> float:
        self.t_open = time.monotonic()
        return self.t_open

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_start - self._excluded

    def close_window(self) -> None:
        """After the window (and the traced stretch): the memory peak."""
        if self._sampler is not None:
            self.memory_peak = self._sampler.stop()
            self._sampler = None
        else:
            import resource

            self.memory_peak = 1024 * resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss

    def close(self) -> None:
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None


def read_metric(name: str, rec: dict):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def metrics_for(bench: dict, cell: str, traced: bool) -> list:
    """The manifest's metrics this cell reports in this kind of run."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def run(ctx: Ctx, variants=()) -> dict:
    """Drive the cell once -> the result object (``variants``: readings of
    a control or a planted fault, also, under ``"variants"``)."""
    from harness import checks, roofline

    driver = importlib.import_module("harness." + ctx.mix["driver"])
    try:
        out = driver.run(ctx)
    finally:
        ctx.close()
    found = forbidden_modules()
    if found:
        raise RunError(f"the measured process holds {found}")
    rec = dict(out, setup_s=ctx.setup_s, cell=ctx.cell["name"])
    if ctx.cuda:
        rec["peaks"] = roofline.peaks(ctx.kind)
    metrics = {}
    for m in metrics_for(ctx.bench, ctx.cell["name"], ctx.trace):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.cuda else "cpu", "kind": ctx.kind,
              "count": ctx.cell["chips"],
              "memory_peak_bytes": int(ctx.memory_peak)}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.rehearse:
        result["rehearsal"] = True
    traced = out.get("traced")
    if traced is not None:
        device.update(busy_s=traced["busy_s"], window_s=traced["stretch_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    readings = out["verify"]()
    correct, compared = checks.judge(readings, ctx.mix["limits"])
    result["correct"] = correct and out["failed"] == 0
    if variants:
        result["variants"] = {v: out["verify"](v) for v in variants}
    found = forbidden_modules()
    if found:
        raise RunError(f"the measured process holds {found}")
    result["checks"] = compared
    return result


def print_result(result: dict) -> None:
    """Each number compared beside its limit as the last lines on
    standard error, then the result as the last line of standard
    output."""
    for name, c in result["checks"].items():
        ok = (c["value"] is not None and c["limit"] is not None
              and c["value"] <= c["limit"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
