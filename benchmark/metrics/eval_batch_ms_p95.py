"""eval_batch_ms_p95: the 95th percentile, over every batch of the
measured window, of a batch's time from its dispatch until its rank
counts are on the host, in ms. Host clock, a few ms a reading."""
from benchmark.common import p95


def read(run):
    return 1e3 * p95(run.unit_s) if run.unit_s else None
