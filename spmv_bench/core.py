"""What the harness and an entry's runner share during one run."""

from __future__ import annotations

import contextlib
import hashlib
import math
import random
import time

import torch


def seed_for(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed, mixed from all of its
    bits: torch's CPU generator keeps only the low 32 bits of a seed, and
    the driver's seeds may pass 2**32."""
    digest = hashlib.blake2b(f"{seed}:{purpose}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") % 2**63


class Run:
    """One run of a cell. The runner of the cell's entry fills `counts`,
    `spans` (host seconds of the program's build, by phase) and the
    window's readings; the harness adds set-up, memory and the trace;
    the metric readers read it all. With `control` the entry runs the
    bfloat16 reference in the program's place. `processes` is the
    number of ranks that run the cell, one card each, `rank` this one's
    (spmv_bench/ranks.py)."""

    def __init__(self, cell: str, config: dict, traffic: dict,
                 limits: dict, seed: int, device: torch.device,
                 control: bool = False, processes: int = 1, rank: int = 0):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits, self.seed, self.device = limits, seed, device
        self.control, self.processes, self.rank = control, processes, rank
        self.entry = traffic["entry"]
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.notes: dict[str, object] = {}
        self.nnz = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.solve_s: list[float] = []
        self.issue_s: list[float] = []
        self.trace = None
        self.traced_work = None

    @contextlib.contextmanager
    def span(self, name: str):
        """Adds the host seconds of the block to spans[name]."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = (self.spans.get(name, 0.0)
                                + time.perf_counter() - t0)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generator(self) -> torch.Generator:
        """A generator on the run's device, seeded from the run's seed."""
        return torch.Generator(device=self.device).manual_seed(
            seed_for(self.seed, "inputs"))


class Reservoir:
    """A uniform sample of k items from a stream of unknown length
    (Li's Algorithm L), drawn from a seeded generator. The caller offers
    item i only when i == self.next, so the rest of the stream costs one
    comparison an item."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self._rng = random.Random(seed)
        self._w = math.exp(math.log(self._u()) / k)
        self.next = 0

    def _u(self) -> float:
        return (self._rng.getrandbits(53) + 0.5) / 2**53

    def take(self, i: int, item) -> int:
        """Keep item i; returns the index of the next item to offer."""
        if len(self.items) < self.k:
            self.items.append(item)
            if len(self.items) < self.k:
                self.next = i + 1
                return self.next
        else:
            self.items[self._rng.randrange(self.k)] = item
            self._w *= math.exp(math.log(self._u()) / self.k)
        skip = math.floor(math.log(self._u()) / math.log(1.0 - self._w))
        self.next = i + 1 + skip
        return self.next
