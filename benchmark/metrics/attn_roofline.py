"""The attention kernels' share of their roofline in the traced window:
the sum over attention calls of the least time the chip could take
(flops.attention_need, flops.bound_s) over the device time of the calls'
kernels, in %."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("attn_device_s"):
        return None
    return 100.0 * tr["attn_bound_s"] / tr["attn_device_s"]
