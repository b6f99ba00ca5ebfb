"""Batched replay: the least time the bytes of the traced calls need at the
card's memory bandwidth over the device time of ``csrc/encode.cu``'s
kernel in those calls, in %."""

from benchmark import roofline

KERNEL = "encode_rows_kernel"


def read(run):
    peak = roofline.hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None or not run.trace.kernel_s(KERNEL):
        return None
    return 100.0 * roofline.encode_bytes(run.traced_calls()) / peak / run.trace.kernel_s(KERNEL)
