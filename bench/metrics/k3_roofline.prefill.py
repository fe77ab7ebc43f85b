"""k3_roofline.prefill: K3's bound over its device time in the profiled
prefill, in %.  The bound of each launch from its shapes (4 hd operations
a kept pair at the bf16 peak, or q, k, v, o at the HBM rate, whichever is
longer; ``bench/counts.py``), one launch an attention layer; the time is
the profiler's, summed over K3's kernels in the slice."""

from bench import counts

K3_KERNELS = ("flash_fwd<", "flash_fwd_tf32<", "flash_fwd_split<", "flash_fwd_merge<")


def read(rec):
    if rec.trace is None or not rec.trace.kernel_count(*K3_KERNELS):
        return None
    g, mix = rec.geometry, rec.cell.traffic
    s = mix["prompt_len"]
    bound = g.layers * counts.k3_bound_s(mix["batch"], g.heads, g.kv_heads, s, s,
                                         g.head_dim, causal=True)
    return 100.0 * bound / rec.trace.kernel_s(*K3_KERNELS)
