"""eval_triples_per_s: every test triple ranked against all entities on
both sides in the measured window, over the window's seconds (each
batch ends with its counts on the host). Host clock."""


def read(run):
    return run.examples / run.window_s
