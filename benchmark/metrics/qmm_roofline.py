"""The qmm kernels' share of their roofline in the traced window: the sum
over qmm calls of the least time the chip could take (flops.qmm_need,
flops.bound_s) over the device time of the calls' kernels, in %."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("qmm_device_s"):
        return None
    return 100.0 * tr["qmm_bound_s"] / tr["qmm_device_s"]
