"""paged_decode_roofline.tpot: the paged decode kernel's share of its
roofline (csrc/paged_attention.cu, decode_attend): over the traced
sub-window, the bytes its decode tokens needed (each token's visible K/V
read once, at most the window, its query and output) over 3.35 TB/s,
divided by the kernel's device seconds in the profiler's trace, in %."""

from benchmark import devtrace, readings, work

KERNELS = ("decode_attend", "paged_decode_kernel")


def read(run):
    tr = readings.trace_of(run)
    if tr is None:
        return None
    dev = devtrace.seconds_of(tr["by_name"], *KERNELS)
    n, keys = readings.decode_tokens_in(run, tr["t0"], tr["t1"])
    d = run["dims"]
    bound = work.bound_s(work.attn_flops(d, keys),
                         work.decode_attn_bytes(d, n, keys))
    return work.share(bound, dev)
