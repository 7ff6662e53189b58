"""Plain forward kinematics of a configuration's model.

Node k: ``R_k = R_parent(k) @ Rxyz(pose_k)``, ``p_k = p_parent(k) + L_k
R_k[:, 0]``; the root ``R_0 = Rxyz(pose_0)``, ``p_0 = origin``; ``Rxyz =
Rx @ Ry @ Rz`` of Euler XYZ angles. Rotations are 9 component tensors
multiplied out elementwise (no batched matrix product of 3x3s). Every
operation runs in the dtype asked for (float64 for the judge, bfloat16
for the control).
"""

from __future__ import annotations

import torch


class Model:
    """A configuration's ``model`` block as tensors on ``device``."""

    def __init__(self, m: dict, device, dtype=torch.float64):
        self.parent = [int(p) for p in m["parent"]]
        self.effectors = [int(e) for e in m["effector_idx"]]
        self.num_nodes = len(self.parent)
        self.dof = 3 * (self.num_nodes - 1)
        self.dtype = dtype

        def t(x):
            # The program holds the numbers in float32; so does the judge's input.
            return torch.tensor(x, dtype=torch.float32, device=device).to(dtype)

        self.length = [float(torch.tensor(v, dtype=torch.float32)) for v in m["length"]]
        self.pose = t(m["pose"])
        self.origin = t(m["origin"])
        self.effector_weight = t(m["effector_weight"])
        # Joint limits of the D angles, node-major, as the program holds them.
        self.lo = torch.tensor(m["min_rotation"][1:], dtype=torch.float32,
                               device=device).reshape(-1)
        self.hi = torch.tensor(m["max_rotation"][1:], dtype=torch.float32,
                               device=device).reshape(-1)

    def anchor(self) -> torch.Tensor:
        """The canonical pose's ``(D,)`` angles."""
        return self.pose[1:].reshape(-1)


def euler_xyz(ax, ay, az) -> list:
    """The 9 components, row-major, of ``Rx @ Ry @ Rz`` of Euler XYZ angles
    (tensors or floats of one shape)."""
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    return [cy * cz, -cy * sz, sy,
            cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy,
            sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy]


def mul3(a: list, b: list) -> list:
    """The row-major product of two 9-component rotations."""
    return [a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
            for i in range(3) for j in range(3)]


def node_positions(model: Model, angles: torch.Tensor, only=None) -> list:
    """Per node k, its position's 3 components (``(...)`` tensors) for
    ``(..., D)`` angles, in ``angles``' dtype; with ``only``, the nodes
    listed there alone are kept."""
    dtype = angles.dtype
    root = model.pose[0].to(dtype)
    origin = model.origin.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=angles.device)
    rots = [euler_xyz(root[0], root[1], root[2])]
    poss = [[origin[i] + zero for i in range(3)]]
    for k in range(1, model.num_nodes):
        j = 3 * (k - 1)
        rk = mul3(rots[model.parent[k]], euler_xyz(angles[..., j], angles[..., j + 1],
                                                   angles[..., j + 2]))
        pp = poss[model.parent[k]]
        length = model.length[k]
        poss.append([pp[i] + length * rk[3 * i] for i in range(3)])
        rots.append(rk)
    keep = range(model.num_nodes) if only is None else only
    return [poss[k] for k in keep]


def positions(model: Model, angles: torch.Tensor) -> torch.Tensor:
    """``(..., N, 3)`` node positions of ``(..., D)`` angles."""
    lead = angles.shape[:-1]
    return torch.stack([torch.stack([c.expand(lead) for c in p], -1)
                        for p in node_positions(model, angles)], -2)


def effector_error(model: Model, angles: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``(...,)`` summed Euclidean distance of the effectors to their
    ``(..., E, 3)`` targets: the upstream's ``checkDistance``."""
    total = 0.0
    t = targets.to(angles.dtype)
    for e, p in enumerate(node_positions(model, angles, model.effectors)):
        d2 = sum((p[i] - t[..., e, i]) ** 2 for i in range(3))
        total = total + torch.sqrt(d2)
    return total


def fitness(model: Model, angles: torch.Tensor, targets: torch.Tensor,
            anchor: torch.Tensor, angle_weight: float) -> torch.Tensor:
    """The PSO cost of ``(S, P, D)`` candidates for ``(S, E, 3)`` targets
    and ``(S, D)`` anchors: the weighted squared effector error plus
    ``angle_weight / J`` times the squared angle change, J = D / 3."""
    t = targets[:, None].to(angles.dtype)
    w = model.effector_weight.to(angles.dtype)
    cost = 0.0
    for e, p in enumerate(node_positions(model, angles, model.effectors)):
        cost = cost + w[e] * sum((p[i] - t[..., e, i]) ** 2 for i in range(3))
    if angle_weight:
        da = angles - anchor[:, None].to(angles.dtype)
        cost = cost + (angle_weight / (model.dof // 3)) * (da * da).sum(-1)
    return cost


def uniform_angles(model: Model, generator: torch.Generator, count: int) -> torch.Tensor:
    """``(count, D)`` float32 angles, uniform over each joint's range."""
    u = torch.rand((count, model.dof), generator=generator, device=generator.device,
                   dtype=torch.float32)
    lo, hi = model.lo.to(u.device), model.hi.to(u.device)
    return lo + u * (hi - lo)


def reachable_targets(model: Model, generator: torch.Generator, count: int) -> torch.Tensor:
    """``(count, E, 3)`` float32 targets: the effectors of uniform
    in-limit poses (the inputs of the batch cells)."""
    a = uniform_angles(model, generator, count)
    return torch.stack([torch.stack(p, -1) for p in node_positions(model, a, model.effectors)],
                       -2).float()

