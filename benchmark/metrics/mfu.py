"""Model operations of every token processed in the traced window (the
products over the active rows' tokens, the head once a sequence, and
attention over each token's context), over the window times the chip's
bf16 peak, in %. Only calls whose kernels ran in the window count."""


def read(run):
    tr = run.trace
    if not tr or "useful_ops" not in tr or not tr["useful_ops"]:
        return None
    return 100.0 * tr["useful_ops"] / (tr["window_s"] * tr["peak_flops"])
