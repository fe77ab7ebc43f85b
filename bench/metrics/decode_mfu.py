"""decode_mfu: the decode steps' roofline time over the program's decode
span, summed over the window's batches run without the profiler, in %.
A step writing position p attends over p + 1 keys; its roofline time is
the larger of its FLOPs at the bf16 peak and its bytes (every weight once,
the cache read up to p and written at p, the logits) at the HBM rate
(``bench/counts.py``)."""

from bench import counts


def read(rec):
    mix = rec.cell.traffic
    b, p0, steps = mix["batch"], mix["prompt_len"], mix["decode_len"]
    if not steps:
        return None
    bound = sum(counts.roofline_s(*counts.decode_step_counts(rec.geometry, b, p0 + i))
                for i in range(steps))
    batches = rec.timed()
    spent = sum(x.stats.decode_ms_per_token * steps / 1e3 for x in batches)
    return 100.0 * bound * len(batches) / spent
