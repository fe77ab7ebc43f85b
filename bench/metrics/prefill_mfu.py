"""prefill_mfu: the prefill's roofline time over its measured span, summed
over the window's batches run without the profiler, in %.  Roofline time:
the larger of the prefill's model FLOPs (routed experts only, causal
attention, the LM head on the last position) at the bf16 peak and its
bytes at the HBM rate (``bench/counts.py``)."""

from bench import counts


def read(rec):
    mix = rec.cell.traffic
    bound = counts.roofline_s(*counts.prefill_counts(rec.geometry, mix["batch"],
                                                     mix["prompt_len"]))
    batches = rec.timed()
    return 100.0 * bound * len(batches) / sum(b.stats.prefill_ms / 1e3 for b in batches)
