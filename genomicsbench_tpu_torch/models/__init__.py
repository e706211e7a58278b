"""Neural models: the CTC basecaller (nn-base) and the Clair variant caller
(nn-variant), and the basecaller's trainer and checkpoints (train)."""

import time

import torch


class StepTimer:
    """The seconds of a step's stages, each waited for on the card, added
    into `stats` (a dict), or nothing where stats is None."""

    def __init__(self, stats, dev):
        self.stats, self.dev = stats, dev
        self.t0 = time.perf_counter()

    def lap(self, name):
        if self.stats is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.stats[name] = self.stats.get(name, 0.0) + now - self.t0
        self.t0 = now
