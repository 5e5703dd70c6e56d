"""Toy sizes of the traffic kinds that came after tests/toy.py's
TOY_TRAFFIC, registered there for the tests that run every cell at toy
sizes; a benchmark change that edits toy.py moves them into it and drops
this file."""
from benchmark.tests import toy

toy.TOY_TRAFFIC.setdefault("eval_dist_batches", dict(
    batch=16, ring_batches=6, chunk=512, trace_batches=4))
