"""train_mfu: the model FLOPs of the window's steps (6 a token for every
weight it multiplies by, the LM head too, and causal attention forward and
backward; recomputation under remat not counted; ``bench/counts.py``) at
the bf16 peak, over the window's time, in %."""

from bench import counts


def read(rec):
    mix = rec.cell.traffic
    flops = counts.train_step_flops(rec.geometry, mix["batch"], mix["seq"]) * rec.steps
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / rec.window_s
