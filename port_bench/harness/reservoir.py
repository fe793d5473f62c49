"""A uniform sample of the window's calls, drawn from the seed."""

from __future__ import annotations

from typing import Callable, List

import numpy as np


class Reservoir:
    """Keeps ``k`` of the items offered, each equally likely (Algorithm R).
    ``offer`` calls ``make()`` only for an item that is kept."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List[tuple] = []

    def offer(self, make: Callable[[], object]) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((self.seen, make()))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = (self.seen, make())

    def sample(self) -> list:
        """The kept items in the order they were offered."""
        return [item for _, item in sorted(self.items, key=lambda t: t[0])]
