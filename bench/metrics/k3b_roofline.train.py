"""k3b_roofline.train: K3b's bound over its device time in the profiled
training steps, in %.  Each step runs K3b once an attention layer; the
bound of each launch from its shapes (10 hd operations a kept pair at the
bf16 peak, or its bytes at the HBM rate, whichever is longer;
``bench/counts.py``); the time is the profiler's, summed over K3b's
kernels (row statistics, dq, dk/dv)."""

from bench import counts

K3B_KERNELS = ("bwd_dq", "bwd_dkdv", "bwd_rowstats", "flash_bwd_tf32")


def read(rec):
    if rec.trace is None or not rec.trace.kernel_count(*K3B_KERNELS):
        return None
    g, mix = rec.geometry, rec.cell.traffic
    s = mix["seq"]
    bound = mix["trace_steps"] * g.layers * counts.k3b_bound_s(
        mix["batch"], g.heads, g.kv_heads, s, s, g.head_dim, causal=True)
    return 100.0 * bound / rec.trace.kernel_s(*K3B_KERNELS)
