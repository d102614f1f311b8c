"""The port's landmark-sharded bundle adjustment (parallel/dist_ba.py) on
the CPU, against its single-device solver and the JAX package's.

- Over a world of one the distributed solve is full_ba to the bit.
- Two gloo processes at lm=2 (spawned, FileStore, each joined with its own
  timeout) agree with the single-process solve within
  tests/test_dist_ba.py's tolerances (1e-4 on cameras, 1e-3 on points),
  and an odd point capacity raises on both.
- Frozen cameras and points stay where they were.
- batched_distributed_full_ba is one full_ba call and equals full_ba
  problem by problem; over the two gloo ranks its rows equal their
  distributed solves alone.
- The port's solve against the JAX package's distributed_full_ba on its
  8-device CPU mesh, on the same numpy problem, at the same tolerances.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from racing_slam_tpu.parallel.dist_ba import distributed_full_ba as jax_distributed_full_ba
from racing_slam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from racing_slam_tpu_torch.ops.ba import BAProblem, full_ba
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.parallel.dist_ba import (
    batched_distributed_full_ba,
    distributed_full_ba,
    shard_problem,
)
from racing_slam_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from tests.test_dist_ba import _perturbed_problem
from tests.torch_mp_worker import ba_worker, run_ranks, stacked_points

torch.set_num_threads(2)


def _both(rng, n_points=128):
    """The perturbed rig of tests/test_dist_ba.py: (JAX camera, JAX
    problem, the port's camera, the port's problem)."""
    cam, poses, X, prob = _perturbed_problem(rng, n_points)
    tprob = BAProblem(*[torch.from_numpy(np.array(x)) for x in prob])
    tprob = tprob._replace(obs_cam=tprob.obs_cam.long())
    return cam, prob, Camera(*cam), tprob, poses


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got.cam_t), np.asarray(want.cam_t), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.cam_rvec), np.asarray(want.cam_rvec), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.points), np.asarray(want.points), atol=1e-3)
    assert int(got.num_residuals) == int(want.num_residuals)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone (FileStore in the test's
    directory), so that the mesh's collectives run; left again after the
    test."""
    assert initialize_distributed(num_processes=1, process_id=0,
                                  store_path=str(tmp_path / "store"), device="cpu") == 1
    yield
    dist.destroy_process_group()


def test_lone_process_mesh_is_none():
    """Without a group the mesh is the single process (None); sizes that
    need more ranks raise."""
    assert make_mesh({"seq": 1, "lm": 1}, device="cpu") is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"lm": 2}, device="cpu")
    assert not dist.is_initialized()


def test_world_of_one_equals_full_ba(rng, world_of_one):
    _, _, cam, prob, _ = _both(rng)
    mesh = make_mesh({"lm": 1}, device="cpu")
    assert mesh is not None
    got = distributed_full_ba(cam, prob, mesh)
    want = full_ba(cam, prob)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(distributed_full_ba(cam, prob), want):  # no mesh: full_ba itself
        assert torch.equal(a, b)


def test_two_gloo_processes_match_single_process(rng, tmp_path):
    """Also the stacked solve over the two ranks (batched_distributed_full_ba
    of the problem and a moved copy, each point shard per problem): its
    first row equals the ranks' distributed solve of the problem alone to
    the bit, and its second the single-process solve of the copy within
    the same tolerances."""
    _, _, cam, prob, poses = _both(rng)
    np.savez(tmp_path / "problem.npz", cam=np.array(list(cam), np.float64),
             **{f: getattr(prob, f).numpy() for f in BAProblem._fields})
    codes = run_ranks(ba_worker, 2, str(tmp_path), timeout_s=180.0)
    assert codes == [0, 0], codes
    want = full_ba(cam, prob)
    want_moved = full_ba(cam, prob._replace(points=stacked_points(prob.points)))
    for r in range(2):
        with np.load(tmp_path / f"ba{r}.npz") as d:
            assert bool(d["raised"]), "an odd point capacity over 2 shards did not raise"
            got = type(want)(*[d[f] for f in want._fields])
            batched = type(want)(*[d["b_" + f] for f in want._fields])
        _assert_close(got, want)
        np.testing.assert_allclose(got.cam_t[2], poses[2][:3, 3], atol=2e-3)
        for a, b in zip(batched, got):
            np.testing.assert_array_equal(a[0], b)
        _assert_close(type(want)(*[x[1] for x in batched]), want_moved)


def test_frozen_cameras_and_points_stay(rng, world_of_one):
    _, _, cam, prob, _ = _both(rng)
    frozen = torch.zeros(prob.points.shape[0], dtype=torch.bool)
    frozen[:32] = True
    prob = prob._replace(point_free=prob.point_free & ~frozen)
    res = distributed_full_ba(cam, prob, make_mesh({"lm": 1}, device="cpu"))
    assert torch.equal(res.cam_t[:2], prob.cam_t[:2])
    assert torch.equal(res.cam_rvec[:2], prob.cam_rvec[:2])
    assert torch.equal(res.points[:32], prob.points[:32])
    assert not torch.equal(res.points[32:], prob.points[32:])


def test_indivisible_capacity_raises(rng):
    _, _, cam, prob, _ = _both(rng, n_points=126)
    with pytest.raises(ValueError, match="not divisible"):
        shard_problem(prob, 8, 0)
    assert shard_problem(prob, 2, 1).points.shape[0] == 63


def test_batched_equals_per_problem_full_ba(rng, world_of_one, monkeypatch):
    """The B = 3 problems are one full_ba call over the world of one, each
    problem equal to full_ba on it alone, to the bit."""
    from racing_slam_tpu_torch.parallel import dist_ba

    probs = [_both(np.random.default_rng(s))[3] for s in (1, 2, 3)]
    cam = _both(rng)[2]
    batch = BAProblem(*[torch.stack(xs) for xs in zip(*probs)])
    solves = []
    monkeypatch.setattr(dist_ba, "full_ba", lambda cam, prob, *a, _f=full_ba, **kw: (
        solves.append(prob.points.shape[:-2]) or _f(cam, prob, *a, **kw)))
    res = batched_distributed_full_ba(cam, batch, make_mesh({"seq": 1, "lm": 1}, device="cpu"))
    assert solves == [(3,)], solves
    for b, p in enumerate(probs):
        want = full_ba(cam, p)
        for got, w in zip(res, want):
            assert torch.equal(got[b], w)


def test_matches_the_jax_package_on_its_mesh(rng, world_of_one):
    jcam, jprob, cam, prob, _ = _both(rng)
    want = jax_distributed_full_ba(jcam, jprob, jax_make_mesh({"lm": 8}))
    _assert_close(distributed_full_ba(cam, prob, make_mesh({"lm": 1}, device="cpu")), want)


def test_dryrun_multichip_over_two_ranks(tmp_path):
    """tools/scaling.dryrun_multichip (of __graft_entry__.dryrun_multichip):
    one solve over two gloo ranks agrees with full_ba on rank 0."""
    from racing_slam_tpu_torch.tools.scaling import dryrun_multichip

    rep = dryrun_multichip(2, device="cpu", workdir=str(tmp_path), timeout_s=180.0)
    assert rep["ranks"] == 2 and rep["max_abs_diff_vs_full_ba"] < 1e-4
