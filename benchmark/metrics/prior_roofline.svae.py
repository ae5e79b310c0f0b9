"""The latent phone loop's kernels at their least time on the card (K1's
and K11's operations over the float32 peak, or the statistics read and γ
written over the memory rate, the larger; counted from the shapes) over
the device time of those kernels inside the benchmark's ``forward``
spans, matched by the names the trace prints: K1 the chunked banded
forward, K11 the chunked backward's γ-emitting instance and its row sum
of the loop-back ξ (no other kernel of these names runs in the forward
of a hybrid step)."""

KERNELS = ("forward_llh_chunked_kernel", "estep_acc_chunked_kernel", "sum_rows_kernel")


def read(trace):
    ops = [op for op in trace.device_in("forward") if any(k in op.name for k in KERNELS)]
    if trace.task != "svae_train" or not ops:
        return None
    least = trace.least_s(trace.work["prior_flops"], trace.work["prior_bytes"]) * trace.calls
    return 100.0 * least / sum(op.seconds for op in ops)
