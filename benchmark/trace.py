"""The traced slice of a `--trace 1` run: a few more units of the cell's
own loop under torch.profiler (CPU and CUDA activity), read into the
device's busy time, the traced window, device time by kernel, and the
idle gaps labelled by the harness span the host was inside.

The slice's kernel records are checked against the program's launch
counters (LAUNCHES + REPLAYED, `kernel_names.json`): a trace that lost
records is taken again, up to RETAKES times, and after that is marked
`lost`, and the readers that need it report nothing."""
import time

from .common import HERE, load_json

RETAKES = 3
WINDOW = "bench.window"


def _counts():
    from adapm_tpu_torch.ops import kernels
    return {k: kernels.LAUNCHES[k] + kernels.REPLAYED[k]
            for k in kernels.LAUNCHES}


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def take(run_units, n_units: int, spans, dev) -> dict:
    """Trace n_units more units (run_units(n) runs them, its spans
    annotated) and read the trace; see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    names = load_json(HERE, "kernel_names.json")["kernels"]
    rec = None
    for attempt in range(RETAKES + 1):
        before = _counts()
        torch.cuda.synchronize(dev)
        spans.annotate = True
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    t0 = time.perf_counter()
                    run_units(n_units)
                    torch.cuda.synchronize(dev)
                    wall = time.perf_counter() - t0
        finally:
            spans.annotate = False
        launched = {k: v - before[k] for k, v in _counts().items()
                    if v != before[k]}
        rec = read(prof.events(), names, launched)
        rec["wall_s"], rec["units"], rec["retakes"] = wall, n_units, attempt
        if not rec["lost"]:
            break
    return rec


def read(events, names: dict, launched: dict) -> dict:
    """The trace's reading (see `take`) from its FunctionEvents."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    win, dev_ev, cpu_spans = None, [], []
    for e in events:
        if e.device_type == cuda and e.name.startswith("bench."):
            continue    # the harness's ranges, mirrored on the device row
        if e.device_type == cuda:
            dev_ev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name == WINDOW:
            win = (e.time_range.start, e.time_range.end)
        elif e.name.startswith("bench."):
            cpu_spans.append((e.name[len("bench."):], e.time_range.start,
                              e.time_range.end))
    if win is None:
        win = (min(a for _, a, _ in dev_ev), max(b for _, _, b in dev_ev)) \
            if dev_ev else (0.0, 0.0)
    dev_ev = [(n, max(a, win[0]), min(b, win[1])) for n, a, b in dev_ev
              if b > win[0] and a < win[1]]
    busy = _union([[a, b] for _, a, b in dev_ev])
    kernels = {}
    for n, a, b in dev_ev:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    # records of the program's kernels against its launch counters
    seen = {key: sum(c for n, (c, _) in kernels.items() if sub in n)
            for key, sub in names.items()}
    mismatch = {key: (launched.get(key, 0), seen[key]) for key in names
                if launched.get(key, 0) != seen[key]}
    gaps, prev = {}, win[0]
    for a, b in busy + [[win[1], win[1]]]:
        if a > prev:
            mid = (a + prev) / 2
            label = "outside the harness's spans"
            inner = [(e - s, n) for n, s, e in cpu_spans if s <= mid <= e]
            if inner:
                label = min(inner)[1]
            gaps[label] = gaps.get(label, 0.0) + (a - prev) / 1e6
        prev = max(prev, b)
    return {"window_s": (win[1] - win[0]) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels, "mismatch": mismatch,
            "lost": bool(mismatch) or not dev_ev, "gaps": gaps}


def kernel_s(rec: dict, sub: str) -> tuple:
    """(records, device seconds) of the kernels whose name holds `sub`."""
    n = t = 0
    for name, (c, s) in rec["kernels"].items():
        if sub in name:
            n += c
            t += s
    return n, t


def breakdown(rec: dict) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten largest idle shares by what the host was
    doing, in seconds."""
    ops = sorted(((n[:120], s) for n, (_, s) in rec["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(rec["gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
