"""``scan_step_roofline_pct`` in the frame cell, where it moves
``frame_solves_per_s``."""

from benchmark.core import loader

read = loader.module("metrics", "scan_step_roofline_pct").read
