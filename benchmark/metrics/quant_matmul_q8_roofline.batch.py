"""quant_matmul_q8_roofline.batch: the int8 group-dequant matmul's share
of its roofline (csrc/quant_matmul.cu, qmm_*): over the traced
sub-window, each forward's least time (every quantized layer weight's
codes and scales read once, of the experts its rows route to, plus the
activations; the FLOPs of the attention projections and each token's
top-k experts, not the dense form's every expert), summed over the step
clock's forwards, divided by the kernels' device seconds, in %."""

from benchmark import devtrace, readings, work


def read(run):
    sw = readings.subwindow_work(run)
    if sw is None or run["dims"].weight != "int8":
        return None
    d = run["dims"]
    bound = (work.q8_bound_s(d, sw["decode_forwards"], sw["decode_tokens"])
             + work.q8_bound_s(d, sw["prefill_forwards"],
                               sw["prefill_tokens"]))
    dev = devtrace.seconds_of(run["trace"]["by_name"], "qmm_")
    return work.share(bound, dev)
