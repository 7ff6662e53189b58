"""The scan solver's CUDA-graph route (``ikpso_tpu_torch/pso/graphs.py``,
``harness/trajectory.py::build_solver``) and the host copies it took out
of a kernel-C solve.

On the CPU: the route as a function of what a call carries, the key of a
captured shape, the cache's eviction, the solver's flow from a shape's
first call to its replays (the capture faked), the draws into the
graph's buffers against the eager route's (bits and the generator's
state), the effector gather by a device index against the list's, and
kernel C's per-chain constants packed once against packed anew.

On the card (marker ``card``; they skip without one): the replayed
answers bit for bit against eager solves of the same seeds (on the
card's generators and on a host one, and a capture under the profiler),
the generator's state after each, earlier answers untouched by later
replays, no host sync in a replay, its spans, and the launch counts.
This file imports no JAX, so the card's machine runs it alone:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_solver_graph.py``.
"""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ikpso_tpu_torch.harness import trajectory
from ikpso_tpu_torch.models import library
from ikpso_tpu_torch.models.chain import Obstacles
from ikpso_tpu_torch.ops import fitness as fitness_ops
from ikpso_tpu_torch.ops import fk as fk_ops
from ikpso_tpu_torch.ops import fitness_kernel as fkm
from ikpso_tpu_torch.ops.fitness import FitnessConfig
from ikpso_tpu_torch.pso import graphs, solver
from ikpso_tpu_torch.pso.config import PSOConfig
from ikpso_tpu_torch.utils import profiling


@pytest.fixture
def one_thread():
    """Torch's CPU pool at one thread (the tier-1 run shares the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    return torch.device("cuda", 0)


def _batch(model, s, device, seed, target_rot=False):
    """``model``'s problem batched over ``s`` targets scattered around its
    own, on ``device``."""
    spec, problem = getattr(library, model)(device=device)
    g = torch.Generator().manual_seed(seed)
    e = problem.targets.shape[-2]
    targets = problem.targets.cpu() + 0.3 * torch.randn((s, e, 3), generator=g)
    rot = torch.rand((s, e, 3), generator=g) if target_rot else None
    return spec, library.batched_problem(problem, targets.to(device),
                                         None if rot is None else rot.to(device))


def _fields(res):
    return [getattr(res, f.name) for f in dataclasses.fields(res)]


# --- the route, the key, the cache (CPU) ----------------------------------------


class _FakeCapture:
    """Stands in for ``CapturedSolve`` on the CPU: records what it was
    built from and what it replays."""

    made = []

    def __init__(self, run, problem, pso, num_particles, dof, pool=None):
        self.run, self.shape, self.replays = run, tuple(problem.pose.shape), 0
        self.given_pool, self.pool = pool, ("pool", len(_FakeCapture.made))
        _FakeCapture.made.append(self)

    def __call__(self, problem, generator):
        self.replays += 1
        return ("replayed", self.shape)


def _fake_card(monkeypatch, kernel_c=True, on_card=True):
    """``build_solver``'s solvers on CPU tensors as on the card: with
    ``kernel_c`` kernel C's fitness (its plain twin runs the eager calls),
    with ``on_card`` route seeing the card's device, and the capture
    faked."""
    if kernel_c:
        monkeypatch.setattr(trajectory, "fitness_impl", lambda *a: "kernel-C")
    if on_card:
        real = graphs.route
        monkeypatch.setattr(graphs, "route", lambda device, seen, captured:
                            real("cuda", seen, captured))
    monkeypatch.setattr(graphs, "CapturedSolve", _FakeCapture)
    _FakeCapture.made = []


def _routes(sv, problems):
    """How each call of ``sv`` on ``problems`` ran: ``"eager"``,
    ``"capture"`` (captured, then replayed) or ``"replay"``."""
    out = []
    for i, problem in enumerate(problems):
        made = len(_FakeCapture.made)
        res = sv(problem, torch.Generator().manual_seed(i))
        out.append("capture" if len(_FakeCapture.made) > made
                   else "replay" if isinstance(res, tuple) else "eager")
    return out


@pytest.mark.parametrize("case", ["cpu", "plain", "plain_gjk", "gbest_reduce", "first_call",
                                  "seen"])
def test_route_follows_what_the_call_carries(case, monkeypatch, one_thread):
    # cpu: kernel C on CPU tensors (route sees their device); plain: the
    # CPU's fitness; plain_gjk: a GJK scene; gbest_reduce: a collective an
    # iteration; first_call: three shapes once each; seen: one shape three
    # times, eager, then captured and replayed, then replayed.
    spec, _ = library.arm_7dof()
    pso, build = PSOConfig(iterations=2), dict(num_particles=16, impl="jnp", device="cpu")
    _fake_card(monkeypatch, kernel_c=case not in ("plain", "plain_gjk"), on_card=case != "cpu")
    if case == "plain_gjk":
        build.update(obstacles=Obstacles.from_boxes([[0.0, 0.0, 5.0]], [[0.1, 0.1, 0.1]]),
                     fit=FitnessConfig(collision_backend="gjk"))
    if case == "gbest_reduce":
        build.update(gbest_reduce=lambda v, c: (v, c))
    sv = trajectory.build_solver(spec, pso=pso, **build)
    shapes = (2, 3, 4) if case == "first_call" else (2, 2, 2)
    got = _routes(sv, [_batch("arm_7dof", s, "cpu", s)[1] for s in shapes])
    assert got == (["eager", "capture", "replay"] if case == "seen" else ["eager"] * 3)


def test_route_on_the_card_and_off_it():
    assert graphs.route("cpu", True, True) == "eager"
    assert [graphs.route("cuda", seen, captured) for seen, captured in
            ((False, False), (True, False), (False, True))] == ["eager", "capture", "replay"]


def _key_variants():
    spec, base = _batch("arm_7dof", 4, "cpu", 0)
    wider = _batch("arm_7dof", 5, "cpu", 0)[1]
    flat = base.replace(origin=base.origin[0])  # one (3,) origin for every swarm
    rotated = base.replace(target_rot=torch.zeros_like(base.targets))
    doubled = base.replace(targets=base.targets.double())
    return base, {"S": (wider, 64), "P": (base, 128), "origin_shape": (flat, 64),
                  "target_rot": (rotated, 64), "dtype": (doubled, 64)}


@pytest.mark.parametrize("change", ["S", "P", "origin_shape", "target_rot", "dtype"])
def test_the_key_changes_with_the_shape(change):
    base, variants = _key_variants()
    problem, p = variants[change]
    assert graphs.graph_key(problem, p) != graphs.graph_key(base, 64)
    # The values are not part of the key.
    moved = base.replace(targets=base.targets + 1.0, pose=base.pose * 2.0)
    assert graphs.graph_key(moved, 64) == graphs.graph_key(base, 64)


def test_the_cache_keeps_four_keys_and_drops_the_oldest():
    cache = graphs.GraphCache()
    held = [types.SimpleNamespace(pool=("pool", k)) for k in range(6)]
    for k in range(graphs.GRAPH_KEYS):
        cache.add(("key", k), held[k])
    assert all(("key", k) in cache for k in range(4))
    cache.add(("key", 4), held[4])
    assert ("key", 0) not in cache
    assert all(cache[("key", k)] is held[k] for k in range(1, 5))
    cache.add(("key", 5), held[5])  # the next oldest goes next
    assert ("key", 1) not in cache and ("key", 2) in cache
    assert cache.pool == ("pool", 0)  # the first graph's, kept for the later ones


def test_the_solver_captures_after_a_shapes_first_call(monkeypatch, one_thread):
    # CPU tensors stand in for the card's: the route sees the card and the
    # capture is faked; the eager calls run kernel C's plain twin.
    _fake_card(monkeypatch)
    spec, _ = library.arm_7dof()
    sv = trajectory.build_solver(spec, pso=PSOConfig(iterations=2), num_particles=16,
                                 impl="jnp", device="cpu")
    batches = {s: _batch("arm_7dof", s, "cpu", s)[1] for s in (2, 3, 4, 5, 6)}
    assert _routes(sv, [batches[2]] * 3) == ["eager", "capture", "replay"]
    assert len(_FakeCapture.made) == 1 and _FakeCapture.made[0].replays == 2
    for s in (3, 4, 5, 6):  # four more shapes captured: the first one is dropped
        assert _routes(sv, [batches[s]] * 2) == ["eager", "capture"]
    assert len(_FakeCapture.made) == 5
    # Its graph is gone, and so is its first call: it starts over.
    assert _routes(sv, [batches[2]] * 3) == ["eager", "capture", "replay"]
    assert len(_FakeCapture.made) == 6
    assert _routes(sv, [batches[6]]) == ["replay"]
    # One memory pool for every graph of the solver: the first one's.
    assert _FakeCapture.made[0].given_pool is None
    assert all(c.given_pool == ("pool", 0) for c in _FakeCapture.made[1:])


def test_a_shape_seen_once_is_forgotten_after_four_more(monkeypatch, one_thread):
    _fake_card(monkeypatch)
    spec, _ = library.arm_7dof()
    sv = trajectory.build_solver(spec, pso=PSOConfig(iterations=1), num_particles=16,
                                 impl="jnp", device="cpu")
    batches = {s: _batch("arm_7dof", s, "cpu", s)[1] for s in (2, 3, 4, 5, 6, 7)}
    assert _routes(sv, [batches[s] for s in (2, 3, 4, 5)]) == ["eager"] * 4
    assert _routes(sv, [batches[3]]) == ["capture"]  # still remembered
    # 6 makes four shapes seen once (2, 4, 5, 6) and 7 drops the oldest, 2.
    assert _routes(sv, [batches[s] for s in (6, 7, 2, 2)]) == ["eager"] * 3 + ["capture"]
    assert len(_FakeCapture.made) == 2


# --- the draws, the effector gather, the packing (CPU) ---------------------------


@pytest.mark.parametrize("init_mode", ["warm", "uniform", "hybrid"])
def test_draws_into_buffers_equal_the_eager_routes(init_mode):
    pso = PSOConfig(init_mode=init_mode, inertia_mode="randomized", rekick_interval=3)
    s, p, d = 3, 50, 9
    gen = torch.Generator().manual_seed(11)
    want = solver.drawing_route_draws(gen, pso, s, p, d, "cpu")
    shape = (s, p, d)
    got = solver.ScanDraws(torch.full(shape, 7.0) if init_mode != "warm" else None,
                           torch.full(shape, 7.0),
                           solver.StepDraws(torch.zeros((s, 2), dtype=torch.int32),
                                            solver.draws_per_iteration(pso), p, d))
    gen2 = torch.Generator().manual_seed(11)
    solver.draw_into(got, gen2)
    if init_mode == "warm":
        assert want.position is None
    else:
        assert torch.equal(got.position, want.position)
    assert torch.equal(got.velocity, want.velocity)
    assert torch.equal(got.steps.seeds, want.steps.seeds)
    assert torch.equal(gen2.get_state(), gen.get_state())


@pytest.mark.parametrize("model", ["arm_7dof", "reference_arm"])
def test_the_device_index_gathers_the_lists_rows(model):
    spec, batch = _batch(model, 6, "cpu", 3)
    g = torch.Generator().manual_seed(4)
    angles = torch.rand((6, spec.dof), generator=g) * 6.0 - 3.0
    pose = fk_ops.angles_to_pose(spec, batch.pose[..., 0, :], angles)
    positions = fk_ops.fk_points(spec, pose, batch.origin)
    d = positions[..., list(spec.effector_idx), :] - batch.targets
    want = torch.sum(torch.sqrt(torch.sum(d * d, dim=-1)), dim=-1)
    got = fitness_ops.true_effector_error(spec, pose, batch)
    assert torch.equal(got, want)
    idx = fitness_ops.effector_index(spec.effector_idx, torch.device("cpu"))
    assert idx is fitness_ops.effector_index(spec.effector_idx, torch.device("cpu"))
    assert idx.tolist() == list(spec.effector_idx)


@pytest.mark.parametrize("scene", ["plain", "orientation", "box"])
def test_the_packer_equals_packing_anew(scene):
    spec, batch = _batch("arm_7dof", 4, "cpu", 5, target_rot=scene == "orientation")
    fit = FitnessConfig(angle_weight=0.3, distance_weight=0.1,
                        orientation_weight=0.5 if scene == "orientation" else 0.0)
    obstacles = (Obstacles.from_boxes([[0.5, 0.5, 0.5], [-1.0, 0.2, 0.0]],
                                      [[0.2, 0.3, 0.4], [0.5, 0.5, 0.5]])
                 if scene == "box" else None)
    pack = fkm.kernel_fitness_packer(spec, fit, obstacles)
    other = _batch("arm_7dof", 4, "cpu", 6, target_rot=scene == "orientation")[1]
    first = pack(other)
    for got in (pack(batch), fkm.make_kernel_fitness(spec, batch, fit, obstacles)):
        want = fkm.make_kernel_fitness(spec, batch, fit, obstacles)
        assert torch.equal(got.meta, want.meta) and torch.equal(got.swarm, want.swarm)
        assert got.branches == want.branches
    # The per-chain constants are packed once; the per-swarm ones each call.
    assert pack(batch).meta is first.meta
    # The list-indexed form of the effector weights, as it was packed.
    weights = spec.effector_weight[list(spec.effector_idx)]
    lay = fkm.MetaLayout(spec, 0 if obstacles is None else obstacles.count,
                         scene == "orientation")
    assert torch.equal(first.meta[0, lay.OFF_EW:lay.OFF_EW + spec.num_effectors], weights)


# --- on the card ---------------------------------------------------------------

CARD_CASES = {
    # model, S, P, PSOConfig: the two cells' solvers at small shapes, and
    # the uniform init's position block.
    "arm_7dof": ("arm_7dof", 64, 128, PSOConfig(iterations=12)),
    "reference_arm": ("reference_arm", 8, 1024,
                      PSOConfig(iterations=15, inertia_mode="randomized", inertia=0.5,
                                cognitive=0.5, social=1.25, init_mode="warm")),
    "arm_7dof_uniform": ("arm_7dof", 64, 128,
                         PSOConfig(iterations=12, init_mode="uniform", rekick_interval=4)),
}


def _card_solver(card, name):
    model, s, p, pso = CARD_CASES[name]
    fit = FitnessConfig(angle_weight=3.0 if model == "reference_arm" else 0.0)
    spec, batch = _batch(model, s, card, 9)
    sv = trajectory.build_solver(spec, pso=pso, fit=fit, num_particles=p, impl="jnp",
                                 device=card)

    def eager(problem, gen):
        return solver.solve(spec, problem, gen, pso=pso, fit=fit, num_particles=p,
                            fitness_fn=fkm.make_kernel_fitness(spec, problem, fit))

    return sv, eager, batch


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_replays_equal_eager_solves_bit_for_bit(card, name):
    sv, eager, batch = _card_solver(card, name)
    kept, problem = [], batch
    for seed in (21, 22, 23, 24):  # eager; captured and replayed; two replays
        g_graph = torch.Generator(device=card).manual_seed(seed)
        g_eager = torch.Generator(device=card).manual_seed(seed)
        got = sv(problem, g_graph)
        want = eager(problem, g_eager)
        for a, b in zip(_fields(got), _fields(want)):
            assert a.shape == b.shape and torch.equal(a, b)
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        kept.append((_fields(got), [t.clone() for t in _fields(got)]))
        problem = problem.replace(pose=got.pose)  # the frame loop's warm start
    torch.cuda.synchronize(card)
    # No answer aliases a graph buffer: the later replays left each as it was.
    for held, copy in kept:
        for a, b in zip(held, copy):
            assert torch.equal(a, b)


@pytest.mark.card
def test_replays_on_a_host_generator_equal_eager_solves(card):
    # A CPU generator for a solve on the card: the eager route draws on the
    # host and moves the draws; the replay copies them into its buffers.
    sv, eager, batch = _card_solver(card, "arm_7dof_uniform")
    for seed in (31, 32, 33):
        g_graph, g_eager = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        for a, b in zip(_fields(sv(batch, g_graph)), _fields(eager(batch, g_eager))):
            assert torch.equal(a, b)
        assert torch.equal(g_graph.get_state(), g_eager.get_state())


@pytest.mark.card
def test_a_replay_queues_no_host_sync_and_counts_its_launches(card):
    # The wrappers count where they launch: the eager first call and the
    # second call's capture once each; a replay launches through the graph
    # and counts as a replay alone.
    sv, _, batch = _card_solver(card, "reference_arm")
    iterations = CARD_CASES["reference_arm"][3].iterations

    def counts():
        return (fkm.fused_fitness.launches, solver.scan_step.launches,
                graphs.CapturedSolve.captures, graphs.CapturedSolve.replays)

    start = counts()
    for seed in (1, 2):
        sv(batch, torch.Generator(device=card).manual_seed(seed))
    mid = counts()
    assert tuple(b - a for a, b in zip(start, mid)) == (2, 2 * iterations, 1, 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sv(batch, torch.Generator(device=card).manual_seed(3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(card)
    assert tuple(b - a for a, b in zip(mid, counts())) == (0, 0, 0, 1)


@pytest.mark.card
def test_a_replay_records_its_spans(card):
    sv, _, batch = _card_solver(card, "arm_7dof")
    for seed in (1, 2):  # eager, then captured
        sv(batch, torch.Generator(device=card).manual_seed(seed))
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        sv(batch, torch.Generator(device=card).manual_seed(3))
    got = profiling.spans()
    profiling.clear_spans()
    names = [s.name for s in got]
    assert names == ["ikpso.solve.pack", "ikpso.solve.init", "ikpso.solve.replay",
                     "ikpso.solve"]
    root = got[-1]
    assert root.parent is None and all(s.parent == root.id for s in got[:-1])
    assert got[0].end <= got[1].start and got[1].end <= got[2].start


@pytest.mark.card
def test_a_capture_under_the_profiler_equals_the_eager_solve(card):
    # A benchmark's traced window starts at a shape's second call: its
    # capture runs under the profiler, with the card's activity on.
    sv, eager, batch = _card_solver(card, "reference_arm")
    sv(batch, torch.Generator(device=card).manual_seed(41))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = [sv(batch, torch.Generator(device=card).manual_seed(s)) for s in (42, 43)]
        torch.cuda.synchronize(card)
    for res, seed in zip(got, (42, 43)):
        want = eager(batch, torch.Generator(device=card).manual_seed(seed))
        for a, b in zip(_fields(res), _fields(want)):
            assert torch.equal(a, b)


@pytest.mark.card
def test_two_shapes_share_a_pool_and_replay_in_turns(card):
    # The second shape's graph is captured into the first's memory pool;
    # their replays in either order leave each other's answers alone.
    sv, eager, batch = _card_solver(card, "arm_7dof")
    half = batch.replace(pose=batch.pose[:32], targets=batch.targets[:32],
                         origin=batch.origin[:32])
    for seed in (51, 52):
        for problem in (batch, half):
            sv(problem, torch.Generator(device=card).manual_seed(seed))
    kept = []
    for seed, problem in ((53, batch), (54, half), (55, half), (56, batch)):
        got = sv(problem, torch.Generator(device=card).manual_seed(seed))
        want = eager(problem, torch.Generator(device=card).manual_seed(seed))
        for a, b in zip(_fields(got), _fields(want)):
            assert torch.equal(a, b)
        kept.append((_fields(got), _fields(want)))
    torch.cuda.synchronize(card)
    for held, want in kept:
        for a, b in zip(held, want):
            assert torch.equal(a, b)
