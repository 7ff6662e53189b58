"""The measured window of a closed loop.

One caller: the next call starts when the last has returned to the host.
The window lasts until ``seconds`` have passed and the call in flight has
returned; every call is timed on the host clock from its start to its
result on the host, and the window's time is the sum of all of it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List


@dataclasses.dataclass
class Window:
    """What a window did: each call's seconds, the solves it completed
    (answers returned), and its whole length."""

    call_s: List[float] = dataclasses.field(default_factory=list)
    solves: int = 0
    window_s: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.call_s)


def closed_loop(seconds: float, call: Callable[[int], int]) -> Window:
    """Run ``call(i)`` for i = 0, 1, ... until ``seconds`` have passed at the
    end of a call; ``call`` returns the solves it completed."""
    w = Window()
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        w.solves += call(i)
        t1 = time.perf_counter()
        w.call_s.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            w.window_s = t1 - start
            return w
