"""device_idle.serve: the share of the profiled serving slice (one batch
from its submission through its prefill, capture and first decode steps)
in which no kernel ran on the device, in % (``torch.profiler``: the union
of the kernels' intervals against the slice's host-clock length)."""


def read(rec):
    if rec.trace is None or not rec.trace.kernels:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
