"""Multi-process runtime: process-group set-up and the sharded waypoint sweep.

Port of ``ikpso_tpu/parallel/distributed.py``. Every process runs the same
program; ``initialize`` joins them into one ``torch.distributed`` process
group through a TCP rendezvous at the coordinator's address, and
``sweep_waypoints_multihost`` gives each process a contiguous block of
the waypoints, solves it on the process's own device and all-gathers the
results, so every process returns the whole sweep.

Backend (:func:`pick_backend`): nccl only when every rank owns a card of
its own (as many visible cards as processes), gloo otherwise: for host
tensors, and for ranks that share one card, which nccl refuses. A rank's
device is card ``process_id % device_count`` (:func:`rank_device`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ikpso_tpu_torch.parallel.mesh import world
from ikpso_tpu_torch.utils import seeds


def pick_backend(num_processes: int, device="cpu") -> str:
    """``"nccl"`` when ``device`` is a card and this machine shows one card
    a process, else ``"gloo"``."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def rank_device(device, process_id: int = 0) -> torch.device:
    """The device process ``process_id`` drives: its card (``process_id``
    modulo the visible cards) for ``device="cuda"``, else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               device="cpu") -> None:
    """Join this process to the process group: process ``process_id`` of
    ``num_processes``, meeting at rank 0's ``host:port``
    (``coordinator_address``, a ``tcp://`` rendezvous). A no-op in one
    process: one process asked for, or no coordinator given. ``device``
    picks the backend (:func:`pick_backend`)."""
    if coordinator_address is None or (num_processes or 1) <= 1 or dist.is_initialized():
        return
    if process_id is None:
        raise ValueError("initialize: a process group of several processes needs the "
                         "process_id of this one")
    dist.init_process_group(pick_backend(num_processes, device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_waypoint_slice(num_waypoints: int) -> slice:
    """The contiguous block of waypoints this process owns: ceil(W / n)
    each, the last block shorter."""
    rank, size = world()
    per = -(-num_waypoints // size)
    return slice(rank * per, min((rank + 1) * per, num_waypoints))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``axis`` of ``x`` to a multiple of ``multiple`` by repeating its
    last entry."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge")


def _all_gather(x: np.ndarray) -> np.ndarray:
    """Every process's ``x`` (same shape), stacked in rank order."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    if dist.get_backend() == "nccl":
        t = t.to(rank_device("cuda", dist.get_rank()))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def sweep_waypoints_multihost(spec, problem, waypoints, seed: int, *, batch_size: int = 256,
                              **solve_kwargs):
    """A waypoint sweep split across the processes of the group.

    Each process solves its :func:`process_waypoint_slice` block with
    ``harness.trajectory.solve_waypoints`` on the device of ``problem``,
    under the seed ``utils.seeds.fold_in(seed, rank)`` (one stream per
    process, as JAX folds the process index into its key); the blocks are
    padded to a common length, all-gathered and cut back, so every
    process returns the whole result. ``solves_per_second`` is the sum of
    the processes' rates: they sweep at the same time. Call
    :func:`initialize` first; in one process this is a plain sweep.

    Returns ``(SweepResult, slice)``: the merged result and this process's
    block.
    """
    from ikpso_tpu_torch.harness.trajectory import SweepResult, solve_waypoints

    waypoints = np.asarray(waypoints, np.float32)
    w = waypoints.shape[0]
    rank, size = world()
    per = -(-w // size)
    sl = process_waypoint_slice(w)
    local = waypoints[sl]
    if local.shape[0] == 0:
        raise ValueError(f"process {rank} owns no waypoints ({w} waypoints over {size} "
                         "processes); use fewer processes or more waypoints")
    res = solve_waypoints(spec, problem, local, seeds.fold_in(seed, rank),
                          batch_size=min(batch_size, local.shape[0]), **solve_kwargs)
    if size == 1:
        return res, sl
    ang = _all_gather(pad_to_multiple(res.angles, per))
    err = _all_gather(pad_to_multiple(res.errors, per))
    rate = _all_gather(np.asarray([res.solves_per_second], np.float64))
    merged = SweepResult(
        angles=ang.reshape(size * per, -1)[:w],
        errors=err.reshape(size * per)[:w],
        solves_per_second=float(rate.sum()),
    )
    return merged, sl
