"""device_idle.<kind of cell>: the share of the traced window in which no
operation ran on the card (torch.profiler), in %. Nothing where the
trace lost records."""


def read(run):
    rec = run.trace
    if rec is None or rec["lost"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
