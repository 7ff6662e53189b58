"""Diagnostics streams reproducing the reference's 4-file schema.

A copy of ``ikpso_tpu/utils/diagnostics.py`` (it takes numpy arrays), with
its schema unchanged.

The reference logs, per experiment frame, to four append-mode text
streams (reference Main.cpp:147-154,171-216): all joint angles
(``degrees``), all node positions (``positions``), the aggregate true
effector error (``distance``), and — on each convergence — the
frames-to-converge count (``frames``). Values are ';'-separated, one
frame per line, matching the reference's Excel import pipeline
(Documentation/results.xlsx).

Additionally a structured JSONL writer records one machine-readable
record per solve (target, iterations, final error, wall time) —
SURVEY.md §5 metrics/observability plan.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Dict, Optional

import numpy as np

_STREAMS = ("positions", "degrees", "frames", "distance")


class DiagnosticsWriter:
    """The four reference-compatible diagnostics streams.

    Files are named ``<prefix>-<stream>.txt`` and opened in append
    mode, matching the reference's ``openStream``
    (Main.cpp:300-304, ``ofstream::app``).
    """

    def __init__(self, directory: str, prefix: str = "IK-diagnostics"):
        os.makedirs(directory, exist_ok=True)
        self._files: Dict[str, IO[str]] = {
            name: open(os.path.join(directory, f"{prefix}-{name}.txt"), "a")
            for name in _STREAMS
        }

    def log_frame(self, degrees, positions, distance: float) -> None:
        """One experiment frame (reference Main.cpp:180-195).

        ``degrees``: flat joint angles (D,); ``positions``: flat
        non-root node positions (3*(N-1),); ``distance``: true summed
        effector error.
        """
        deg = np.asarray(degrees).reshape(-1)
        pos = np.asarray(positions).reshape(-1)
        self._files["degrees"].write(";".join(f"{v:g}" for v in deg) + ";\n")
        self._files["positions"].write(";".join(f"{v:g}" for v in pos) + ";\n")
        self._files["distance"].write(f"{float(distance):g}\n")

    def log_convergence(self, frames: int) -> None:
        """Frames-to-converge record (reference Main.cpp:201-202)."""
        self._files["frames"].write(f"{int(frames)}\n")

    def flush(self) -> None:
        for f in self._files.values():
            f.flush()

    def close(self) -> None:
        for f in self._files.values():
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SolveLogger:
    """Structured JSONL log: one record per solve (or per waypoint)."""

    def __init__(self, path: str):
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._file = open(path, "a")

    def log(
        self,
        *,
        target=None,
        iterations: Optional[int] = None,
        final_error: Optional[float] = None,
        fitness: Optional[float] = None,
        wall_time_s: Optional[float] = None,
        **extra,
    ) -> None:
        record = dict(
            ts=time.time(),
            target=None if target is None else np.asarray(target).tolist(),
            iterations=iterations,
            final_error=final_error,
            fitness=fitness,
            wall_time_s=wall_time_s,
        )
        record.update(extra)
        self._file.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
