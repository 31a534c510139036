"""Device time of a call on the card, for chip_smoke.py and the A/B tools."""

from __future__ import annotations

import numpy as np
import torch


class Timer:
    """Median device time (ms) of fn over iters calls. Each call follows an
    L2 flush (a 256 MB write) and a spin of the card (torch.cuda._sleep,
    about 250 us), so the host has queued all of fn's launches before the
    card reaches the first of the CUDA events around them: the time is the
    card's alone, without the gaps of the host's Python and launch
    overhead, which a kernel of tens of microseconds would otherwise show."""

    SPIN_CYCLES = 500_000

    def __init__(self, iters: int):
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(self.iters)]
        for e0, e1 in ev:
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))
