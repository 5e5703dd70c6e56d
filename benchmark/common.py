"""What every cell's run shares: the manifest and the files found by
name, host-clock spans, the profiler trace's reading, and the device's
description."""
import contextlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "adapm_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str, man: dict = None) -> dict:
    """The workload entry `name` with its configuration and traffic mix
    read from their files."""
    man = man or manifest()
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json"
                         f" (cells: {sorted(wl)})")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    return dict(w, config_data=load_json(ROOT, cfg_entry["file"]),
                traffic_data=load_json(HERE, "traffic",
                                       w["traffic"] + ".json"))


def metrics_of(name: str, man: dict, trace: bool) -> list:
    """The metric entries a run of cell `name` reports: the end-to-end
    ones without the trace, the per-layer ones with it."""
    entries = man["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def load_file(kind: str, name: str):
    """A module of the benchmark found by name: kind/name.py, or, where
    that is absent, the module of the name's part before its first dot
    (the metric device_idle.eval is read by metrics/device_idle.py)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so set-up
    counts the interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """Host-clock spans of the harness around its calls into the program:
    seconds per name, one entry a call. With `annotate` each span is also
    a profiler range named bench.<name>, so the trace can say what the
    host was doing in a device gap."""

    def __init__(self):
        self.s = {}
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function("bench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def device_info(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
