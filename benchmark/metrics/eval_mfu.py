"""eval_mfu: a batch's operations bound (the K4 arithmetic over every
entity, both sides: costs/k4 over the f32 peak) over the measured time a
batch (the window's seconds over its batches), in %."""


def read(run):
    if not run.units:
        return None
    return 100.0 * run.k4_ops_s / (run.window_s / run.units)
