"""paged_prefill_roofline.ttft: the paged prefill kernel's share of its
roofline (csrc/paged_attention.cu, attend_prefill_kernel): over the
traced sub-window, the larger of the FLOPs (each prompt token's query
over its visible keys) over 989 TFLOP/s and the bytes (queries, keys,
values and outputs once) over 3.35 TB/s, for the prompt tokens the step
clock prefilled there, at the keys per token of the prompts that finished
there; divided by the kernel's device seconds, in %."""

from benchmark import devtrace, readings, work

KERNELS = ("attend_prefill_kernel", "paged_prefill_kernel")


def read(run):
    sw = readings.subwindow_work(run)
    if sw is None or not sw["prompts"] or sw["prefill_tokens"] <= 0:
        return None
    d = run["dims"]
    dev = devtrace.seconds_of(run["trace"]["by_name"], *KERNELS)
    bound = work.bound_s(work.attn_flops(d, sw["prefill_keys"]),
                         work.prefill_attn_bytes(d, sw["prefill_tokens"]))
    return work.share(bound, dev)
