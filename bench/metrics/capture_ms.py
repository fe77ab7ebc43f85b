"""capture_ms: the median over the window's batches (those run without the
profiler) of the program's ``ServeStats.capture_ms``: one eager warm-up
step, the cache snapshot and restore, and the decode step's CUDA graph
capture, paid once a batch."""

import statistics


def read(rec):
    return statistics.median(b.stats.capture_ms for b in rec.timed())
