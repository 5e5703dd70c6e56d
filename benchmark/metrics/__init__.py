"""One reader a metric, named as BENCHMARK.json names the metric:
read(run) returns the metric's value, or None where the run holds
nothing to read (the result line then leaves the metric out)."""
