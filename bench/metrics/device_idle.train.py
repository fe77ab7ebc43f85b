"""device_idle.train: the share of the profiled training steps (three,
after the window, back to back and ended by a synchronise) in which no
kernel ran on the device, in % (``torch.profiler``)."""


def read(rec):
    if rec.trace is None or not rec.trace.kernels:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
