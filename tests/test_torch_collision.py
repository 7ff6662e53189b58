"""Scene colliders of the port (ikpso_tpu_torch.ops.collision, the
Obstacles model) against the JAX package on identical inputs.

Both sides evaluate the same float32 formulas; only the 3-term dot
products of the frame changes round differently (XLA's CPU einsum sums
them in its own order; the port writes them out in axis order, as the
fitness tile does), so the collision masks must be identical on scenes
that both hit and miss, and the squared distances agree to rtol 1e-6
with an absolute floor of 1e-7, about one float32 ulp at unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikpso_tpu.models import library as jlib
from ikpso_tpu.models.chain import Obstacles as JObstacles
from ikpso_tpu.ops import collision as jcol
from ikpso_tpu.ops import fk as jfk
from ikpso_tpu.ops.rotations import quaternion_to_matrix as j_quat_to_matrix
from ikpso_tpu_torch.models import convert
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import collision
from ikpso_tpu_torch.ops.fitness_kernel import seg_obb_dist2_tile
from ikpso_tpu_torch.ops.rotations import quaternion_to_matrix

DIST_ATOL = 1e-7

# tests/test_pallas.py:52-72 scene: one axis-aligned and one z-rotated box.
PALLAS_SCENE = dict(
    centers=[(1.5, 0.5, 0.0), (-1.0, -1.0, 0.0)],
    full_dims=[(1.0, 1.0, 1.0), (0.8, 0.8, 0.8)],
    quats=[(0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.383, 0.924)],
)


def _rotated_scene(rng, n=4):
    """n boxes near the arm_7dof workspace with random unit quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(centers=rng.uniform(-1.5, 1.5, (n, 3)),
                full_dims=rng.uniform(0.3, 0.9, (n, 3)), quats=q)


def _chain_case(model, s, rng):
    """Node positions / rotations / parent positions of random in-limit
    poses, from the JAX FK (both colliders get the same numbers)."""
    spec_j, problem_j = getattr(jlib, model)()
    lo = np.asarray(spec_j.min_rotation[1:]).reshape(-1)
    hi = np.asarray(spec_j.max_rotation[1:]).reshape(-1)
    ang = (lo + rng.random((s, spec_j.dof)) * (hi - lo)).astype(np.float32)
    pose = jfk.angles_to_pose(spec_j, jnp.broadcast_to(problem_j.pose[0], (s, 3)),
                              jnp.asarray(ang))
    pos, rot = jfk.fk(spec_j, pose, problem_j.origin)
    pos, rot = np.asarray(pos), np.asarray(rot)
    parents = list(spec_j.parent[1:])
    return (pos[:, 1:], rot[:, 1:], pos[:, parents],
            np.asarray(spec_j.length[1:]))


@pytest.mark.parametrize("shape", ["box", "capsule"])
@pytest.mark.parametrize("model,scene", [
    ("planar_3dof", "pallas"), ("arm_7dof", "rotated")])
def test_chain_colliders_match_jax(shape, model, scene):
    rng = np.random.default_rng(60)
    boxes = PALLAS_SCENE if scene == "pallas" else _rotated_scene(rng)
    obs_j = JObstacles.from_boxes(**boxes)
    obs = convert.obstacles_from(obs_j)
    args = _chain_case(model, 2048, rng)
    want = np.asarray(jcol.get_chain_collider("sat", shape)(
        *[jnp.asarray(a) for a in args], obs_j.center, obs_j.half_extent, obs_j.rot))
    got = collision.get_chain_collider("sat", shape)(
        *[torch.as_tensor(a) for a in args], obs.center, obs.half_extent, obs.rot)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.02 < want.mean() < 0.98, "the scene must both hit and miss"


def test_obb_distances_match_jax():
    rng = np.random.default_rng(61)
    obs_j = JObstacles.from_boxes(**_rotated_scene(rng, 3))
    obs = convert.obstacles_from(obs_j)
    p0 = rng.uniform(-2, 2, (512, 1, 3)).astype(np.float32)
    p1 = rng.uniform(-2, 2, (512, 1, 3)).astype(np.float32)
    box_j = (obs_j.center, obs_j.half_extent, obs_j.rot)
    box = (obs.center, obs.half_extent, obs.rot)
    np.testing.assert_allclose(
        collision.point_obb_dist2(torch.as_tensor(p0), *box).numpy(),
        np.asarray(jcol.point_obb_dist2(jnp.asarray(p0), *box_j)), rtol=1e-6, atol=DIST_ATOL)
    got = collision.segment_obb_dist2(torch.as_tensor(p0), torch.as_tensor(p1), *box)
    want = np.asarray(jcol.segment_obb_dist2(jnp.asarray(p0), jnp.asarray(p1), *box_j))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=DIST_ATOL)
    assert (want == 0).any() and (want > 0).any()


def test_axis_aligned_box_with_z0_link():
    # Links in the z = 0 plane against a box centred on z = 0: the
    # box-frame z coordinate is exactly 0 along the whole segment. jnp.sign
    # gives 0 there; the port writes the sign out as (q > 0) - (q < 0).
    # The excess max(|q| - h, 0) is 0 there too, so the derivative must
    # not move, and distances, masks and the tile's bisection agree.
    obs_j = JObstacles.from_boxes([(1.5, 0.0, 0.0)], [(0.4, 0.4, 0.4)])
    obs = convert.obstacles_from(obs_j)
    xs = np.linspace(-0.5, 3.0, 64, dtype=np.float32)
    p0 = np.stack([xs, np.full_like(xs, -1.0), np.zeros_like(xs)], -1)[:, None]
    p1 = np.stack([xs[::-1], np.full_like(xs, 0.7), np.zeros_like(xs)], -1)[:, None]
    box_j = (obs_j.center, obs_j.half_extent, obs_j.rot)
    want = np.asarray(jcol.segment_obb_dist2(jnp.asarray(p0), jnp.asarray(p1), *box_j))
    got = collision.segment_obb_dist2(torch.as_tensor(p0), torch.as_tensor(p1),
                                      obs.center, obs.half_extent, obs.rot)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    blk = torch.as_tensor(np.asarray(obs_j.center))[0]
    oh = tuple(obs.half_extent[0])
    orot = tuple(tuple(obs.rot[0, r, c] for c in range(3)) for r in range(3))
    tile = seg_obb_dist2_tile(tuple(torch.as_tensor(p0[:, 0, i]) for i in range(3)),
                              tuple(torch.as_tensor(p1[:, 0, i]) for i in range(3)),
                              tuple(blk), oh, orot)
    np.testing.assert_allclose(tile.numpy(), want[:, 0], rtol=1e-6, atol=1e-12)
    assert (want == 0).any() and (want > 0).any()


def test_obstacles_from_boxes_matches_jax():
    rng = np.random.default_rng(62)
    boxes = _rotated_scene(rng, 5)
    want = JObstacles.from_boxes(**boxes)
    got = Obstacles.from_boxes(**boxes)
    assert got.count == want.count == 5
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    np.testing.assert_array_equal(got.half_extent.numpy(), np.asarray(want.half_extent))
    np.testing.assert_allclose(got.rot.numpy(), np.asarray(want.rot), atol=1e-7)
    q = torch.as_tensor(np.asarray(boxes["quats"], np.float32))
    np.testing.assert_allclose(quaternion_to_matrix(q).numpy(),
                               np.asarray(j_quat_to_matrix(jnp.asarray(q.numpy()))),
                               atol=1e-7)
    plain = Obstacles.from_boxes([(0.0, 1.0, 2.0)], [(2.0, 4.0, 6.0)])
    np.testing.assert_array_equal(plain.rot.numpy(), np.eye(3)[None])
    np.testing.assert_array_equal(plain.half_extent.numpy(), [[1.0, 2.0, 3.0]])
    assert Obstacles.empty().count == 0


def test_gjk_backend_refused_and_unknown_names_rejected():
    # The GJK backend is ported: it resolves to JAX's colliders' twins and
    # they return JAX's masks (tests/test_torch_gjk.py holds them on
    # random poses); unknown names still raise.
    from ikpso_tpu.ops import gjk as jgjk
    from ikpso_tpu_torch.ops import gjk

    assert collision.get_chain_collider("gjk", "box") is gjk.chain_collides_gjk
    assert collision.get_chain_collider("gjk", "capsule") is gjk.chain_collides_capsule_gjk
    spec_j, problem_j = jlib.arm_7dof()
    boxes = dict(centers=np.array([[1.0, 0.2, 0.0], [0.0, 3.0, 0.0]], np.float32),
                 full_dims=np.array([[0.5, 0.5, 0.5], [0.4, 0.4, 0.4]], np.float32))
    obs_j, obs = JObstacles.from_boxes(**boxes), Obstacles.from_boxes(**boxes)
    pos_j, rot_j = jfk.fk(spec_j, problem_j.pose, problem_j.origin)
    par = np.asarray(spec_j.parent[1:])
    for shape, j_fn in (("box", jgjk.chain_collides_gjk),
                        ("capsule", jgjk.chain_collides_capsule_gjk)):
        want = bool(j_fn(pos_j[1:], rot_j[1:], pos_j[par], spec_j.length[1:],
                         obs_j.center, obs_j.half_extent, obs_j.rot))
        pos, rot = torch.as_tensor(np.asarray(pos_j)), torch.as_tensor(np.asarray(rot_j))
        got = bool(collision.get_chain_collider("gjk", shape)(
            pos[1:], rot[1:], pos[list(par)], torch.as_tensor(np.asarray(spec_j.length[1:])),
            obs.center, obs.half_extent, obs.rot))
        assert got is want is True  # the box at (1, 0.2, 0) sits on the first link
    with pytest.raises(ValueError):
        collision.get_chain_collider("sat", "sphere")
    with pytest.raises(ValueError):
        collision.get_chain_collider("mesh", "box")
