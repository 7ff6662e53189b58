"""``device_idle_pct`` in the frame cell, where it moves
``frame_solves_per_s``."""

from benchmark.core import loader

read = loader.module("metrics", "device_idle_pct").read
