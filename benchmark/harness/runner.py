"""One run of one cell: find its files by name, set up, measure, check,
and build the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under the benchmark's directory,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix, which names its driver
  ``traffic/<driver>.py`` (a ``Driver`` class: ``setup()``,
  ``window(tracing)``, ``release()``, ``check()``);
* ``workloads/<cell>.json``: the cell's own settings (engine arguments,
  overrides of the mix's parameters, the limits of the check, and
  ``host_threads``: PyTorch's intra-op threads on the host, where the cell
  fixes them);
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run)`` returning a number or None (nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # the benchmark's dir
FORBIDDEN = ("jax", "jaxlib", "flax", "shgan_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as a run sees it: its manifest entry, files and arguments."""

    def __init__(self, manifest, name, seed, seconds, trace, device,
                 root=HERE, t_start=None):
        self.manifest = manifest
        entry = next((w for w in manifest["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in the manifest")
        self.name, self.entry, self.root = name, entry, Path(root)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.t_window = None
        self.config = load_json(self.root / "configs" / f"{entry['config']}.json")
        self.settings = load_json(self.root / "workloads" / f"{name}.json")
        self.traffic = dict(load_json(
            self.root / "traffic" / f"{entry['traffic']}.json"))
        self.traffic.update(self.settings.get("traffic", {}))
        self.driver_path = self.root / "traffic" / f"{self.traffic['driver']}.py"

    def start_window(self):
        """Called at the first timed item: set-up ends here."""
        self.t_window = time.perf_counter()
        return self.t_window

    def end_to_end(self):
        """This cell's end-to-end metrics from the manifest."""
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """This cell's per-layer metrics: those listing it, and those
        without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric):
        path = self.root / "metrics" / f"{metric}.py"
        return load_module(path, "metric_" + metric.replace(".", "_")
                           .replace("-", "_")).read


class Run:
    """What a per-layer reader sees: the cell, the driver's facts and the
    reduced trace."""

    def __init__(self, cell, facts, trace, kind):
        self.cell, self.facts, self.trace, self.kind = cell, facts, trace, kind


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def cuda_devices():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_info(count):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count))),
            "power_limit": smi[0].split(",")[-1].strip() if smi else None}


def execute(cell, device_fn=None, log=None):
    """Run ``cell`` once; returns the result dict (the last line)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    import torch
    # the configuration's stated precision: cuDNN's TF32 on or off; matrix
    # products in float32
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell.settings.get("host_threads"):
        torch.set_num_threads(int(cell.settings["host_threads"]))
    driver = load_module(cell.driver_path,
                         "driver_" + cell.traffic["driver"]).Driver(cell, log)
    driver.setup()
    out = driver.window(bool(cell.trace))
    if cell.t_window is None:
        raise RuntimeError("the driver never started its window")
    setup_s = cell.t_window - cell.t_start
    device = device_fn() if device_fn else {"platform": cell.device.type,
                                            "kind": str(cell.device),
                                            "count": 1,
                                            "memory_peak_bytes": 0}
    driver.release()
    checks = driver.check()
    correct = all(v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        log(f"check {name} = {v!r} (limit {lim!r}): "
            f"{'ok' if v <= lim else 'FAILED'}")
    metrics = {}
    trace = out.get("trace")
    if cell.trace:
        run = Run(cell, out["facts"], trace, device.get("kind"))
        for m in cell.per_layer():
            v = cell.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if trace is not None:
            device["busy_s"] = trace.busy_s
            device["window_s"] = trace.window_s
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end():
            if m["name"] not in values:
                raise KeyError(f"cell {cell.name}: the driver measured no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace and trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result
