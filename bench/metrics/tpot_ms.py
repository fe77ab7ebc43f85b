"""tpot_ms: all decode time of the window over all its decode steps, on the
harness's clock.  A batch decodes from its first decode step (the device
synchronised) to the serving entry's return of its tokens; the decode
graph's capture before that step is not in it (``capture_ms``)."""


def read(rec):
    batches = [b for b in rec.timed() if b.t_decode is not None]
    steps = sum(b.tokens.shape[1] - 1 for b in batches)
    if not steps:
        return None
    return 1e3 * sum(b.t_return - b.t_decode for b in batches) / steps
