"""The port's multi-sequence step under the learned configuration:
MultiSlam and slam_step_multi with the SuperPoint frontend and LightGlue,
on the tiny world of tests/torch_multi_world.py (2 sequences, 10 frames,
320x240), on the CPU.

(a) MultiSlam with SuperPointFrontend (the committed weights) and
    matcher="lightglue" (LightGlue on lightglue_superpoint.npz, picked by
    the descriptor dimension) against each sequence's own Slam run
    (seed=i): every leaf of the state equal to the bit and the rows'
    essential predictions equal, under constant velocity (LightGlue at the
    commits, over the rows that commit on a lockstep frame), with every
    row committing on every frame (min_commit_inliers above any inlier
    count: LightGlue and K4 over both rows at each commit), and under
    essential_matrix_estimation (LightGlue over both rows every lockstep
    frame). The fleet's Slams share one frontend and load the LightGlue
    weights once.
(b) slam_step_multi against the JAX package's multi_sequence_step with its
    SuperPointFrontend and LightGlueMatcher, from JAX's
    MultiSlam.initialize() states, under essential_matrix_estimation
    (LightGlue over the stacked rows in the prediction), over 3 frames,
    each frame one step from JAX's states of the frame before
    (tests/test_torch_multi_seq.py's one-step rule), each row's RANSAC
    uniforms drawn from JAX's key for that row and frame as
    jax.random.uniform(key, (H, K)). No step commits (keyframe_match_ratio
    0; test_torch_multi_seq.py says why). JAX's LightGlue runs its Pallas
    attention kernel in interpret mode (attn_backend="pallas_interpret"),
    the arithmetic K6 and its twin follow (bf16 operands, float32 sums).
    JAX's mesh is {"seq": 1, "lm": 8}: with the rows sharded over 2
    devices, XLA on the CPU refuses the vmapped SuperPoint's 1x1
    convolution (it folds the rows into a feature group of 2, and 65
    output features do not divide by 2). Tolerances:
    tests/test_torch_models.py::test_learned_step_matches_jax's, per row:
    the same SuperPoint keypoint within 0.05 px on >= 99 %, the chosen map
    point on >= 97 % of the keypoints that either side matched, the pose
    to 1e-4 rad and 1e-3 units, the keyframe decision exactly and the
    inlier count within 2 %; and at least 20 map points matched a row (the
    tiny map's weakest frame here matches 21).
(c) The K6 twin over S=3 problems against three single calls, and
    lightglue.assignment_scores and match over S=3 pairs against three
    single calls (atol 0).
(d) SuperPointFrontend.extract over [3, H, W] against each frame alone,
    with and without a mask (atol 0).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from racing_slam_tpu.models import superpoint as jsp
from racing_slam_tpu.ops.camera import Camera as JaxCamera
from racing_slam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from racing_slam_tpu.parallel.multi_seq import MultiSlam as JaxMultiSlam
from racing_slam_tpu.parallel.multi_seq import multi_sequence_step as jax_multi_sequence_step
from racing_slam_tpu.slam.config import SlamConfig as JaxSlamConfig
from racing_slam_tpu.utils.video import ArraySource as JaxArraySource
from racing_slam_tpu_torch.models import WEIGHTS_DIR, lightglue, superpoint
from racing_slam_tpu_torch.ops.kernels import attention as k6
from racing_slam_tpu_torch.parallel.multi_seq import MultiSlam
from racing_slam_tpu_torch.slam import pipeline as tp
from racing_slam_tpu_torch.slam.frontend import LightGlueMatcher
from racing_slam_tpu_torch.slam.state import stack_states
from racing_slam_tpu_torch.utils.checkpoint import _named_leaves
from racing_slam_tpu_torch.utils.convert import state_from_numpy
from racing_slam_tpu_torch.utils.video import ArraySource
from torch_multi_world import tiny_cfg, tiny_world

torch.set_num_threads(2)

# The learned path's LightGlue threshold on the tiny world
# (tests/test_torch_models.py::test_learned_path_tracks).
LEARNED = dict(matcher="lightglue", lightglue_threshold=0.2)


def _u8(f):
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


def _equal_states(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_named_leaves(a).values(),
                                                 _named_leaves(b).values()))


@pytest.fixture(scope="module")
def world():
    return tiny_world()


@pytest.fixture(scope="module")
def sp_params():
    return superpoint.load_params(WEIGHTS_DIR / "superpoint.npz", device="cpu")


def _frontend(sp_params):
    return superpoint.SuperPointFrontend(sp_params, device="cpu")


CASES = {"constant_velocity": {}, "forced_commits": dict(min_commit_inliers=1 << 30),
         "essential": dict(essential_matrix_estimation=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_multi_slam_learned_matches_per_sequence_slam(world, sp_params, monkeypatch, case):
    """(a): every leaf to the bit after 6 lockstep frames (batches of 3)."""
    cam, seqs = world
    extra = CASES[case]
    cfg = tiny_cfg(pose_prediction="constant_velocity", **LEARNED, **extra)
    single, slams = [], []
    for i, s in enumerate(seqs):
        slam = tp.Slam(cam, ArraySource(s.frames), cfg, seed=i, frontend=_frontend(sp_params),
                       device="cpu")
        assert slam.initialize()
        slam.run_batched(max_frames=6, batch=3)
        single.append(slam.state)
        slams.append(slam)
    loads = []
    load = lightglue.load_params
    monkeypatch.setattr(lightglue, "load_params", lambda *a, **kw: loads.append(a) or load(*a, **kw))
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, cfg,
                   frontend=_frontend(sp_params), device="cpu")
    assert len(loads) == 1  # one LightGlue for the fleet
    assert isinstance(ms.frontend.matcher, LightGlueMatcher)
    assert ms.frontend.matcher.params.in_proj_w.shape[0] == 256
    assert ms.initialize()
    assert ms.run_batched(max_frames=6, batch=3) == 6
    assert ms.host_syncs == ms.frames_stepped == 6
    assert ms.essential_predictions == [s.essential_predictions for s in slams]
    assert ms.essential_predictions == ([6, 6] if case == "essential" else [0, 0])
    commits = 0
    for got, want in zip(ms.states_per_sequence(), single):
        assert got.obs_desc.shape[-1] == 256
        assert int(got.num_kf) == int(want.num_kf)
        commits += int(got.num_kf) + int(got.arch_count) - 2
        assert _equal_states(got, want)  # every leaf, to the bit
    assert commits > 0  # LightGlue ran at a commit on some row
    if case == "forced_commits":
        assert commits == 2 * 6  # both rows on every lockstep frame


def test_step_matches_jax_multi_sequence_step_learned(world):
    """(b); the tolerances are in the module docstring."""
    cam, seqs = world
    cfg = tiny_cfg(pose_prediction="constant_velocity", motion_ba_iters=10,
                   keyframe_match_ratio=0.0, essential_matrix_estimation=True, **LEARNED)
    jcfg = JaxSlamConfig(**dataclasses.asdict(cfg))
    jcam = JaxCamera(*cam)
    mesh = jax_make_mesh({"seq": 1, "lm": 8})
    jfe = jsp.SuperPointFrontend(params=jsp.load_params(WEIGHTS_DIR / "superpoint.npz"))
    jms = JaxMultiSlam(jcam, [JaxArraySource(s.frames) for s in seqs], mesh, jcfg, frontend=jfe)
    jms.frontend.matcher.attn_backend = "pallas_interpret"
    assert jms.initialize()
    multi = jax_multi_sequence_step(mesh, cam=jcam, cfg=jcfg, frontend=jms.frontend)
    jstates = jax.tree.map(np.asarray, jms.states)
    frontend = superpoint.SuperPointFrontend(
        superpoint.load_params(WEIGHTS_DIR / "superpoint.npz", device="cpu"), device="cpu")
    tp.Slam(cam, ArraySource([]), cfg, frontend=frontend, device="cpu")  # sets its LightGlue
    start = jstates.frame_count.tolist()
    K = jstates.last_feat.xy.shape[1]
    key = jax.random.PRNGKey(5)
    for j in range(3):
        imgs = np.stack([_u8(seqs[i].frames[start[i] + j]) for i in range(2)])
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 2)
        uniforms = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            keys[i], (cfg.ransac_hypotheses, K))) for i in range(2)]))
        states = stack_states([state_from_numpy(jax.tree.map(lambda x, i=i: x[i], jstates),
                                                device="cpu") for i in range(2)], device="cpu")
        jout, jinfo = multi(jstates, imgs[:, None], np.asarray(keys).reshape(2, 1, -1),
                            np.ones((2, 1), bool), None)
        jstates = jax.tree.map(np.asarray, jout)
        states, info = tp.slam_step_multi(
            states, torch.from_numpy(imgs), [True, True], None, cam=cam, cfg=cfg,
            frontend=frontend, uniforms=uniforms, last_inliers=states.last_inliers.tolist())
        assert info.essential_prediction == [True, True]
        for i in range(2):
            jxy, txy = jstates.last_feat.xy[i], states.last_feat.xy[i].numpy()
            assert np.all(np.abs(jxy - txy) < 0.05, axis=-1).mean() >= 0.99
            jm, tm = jstates.last_matches[i], states.last_matches[i].numpy()
            assert (jm >= 0).sum() >= 20
            either = (jm >= 0) | (tm >= 0)
            assert (jm[either] == tm[either]).mean() >= 0.97, (j, i)
            jn, tn = int(jstates.last_inliers[i]), info.n_inliers[i]
            assert abs(tn - jn) <= 0.02 * jn, (j, i, tn, jn)
        np.testing.assert_allclose(states.last_rvec.numpy(), jstates.last_rvec, atol=1e-4)
        np.testing.assert_allclose(states.last_t.numpy(), jstates.last_t, atol=1e-3)
        assert info.is_keyframe == np.asarray(jinfo.is_keyframe).reshape(2).tolist()
        np.testing.assert_array_equal(states.num_kf.numpy(), jstates.num_kf)


def test_batched_k6_twin_and_lightglue_equal_single_calls():
    """(c)."""
    rng = np.random.default_rng(12)
    S, K0, K1 = 3, 250, 333
    q = torch.from_numpy(rng.normal(size=(S, K0, 4, 32)).astype(np.float32))
    k, v = [torch.from_numpy(rng.normal(size=(S, K1, 4, 32)).astype(np.float32))
            for _ in range(2)]
    mask = torch.from_numpy(np.stack([rng.random(K1) < f for f in (0.8, 0.0, 0.5)]))
    out = k6.flash_mha(q, k, v, mask)
    assert out.shape == (S, K0, 4, 32)
    for s in range(S):
        assert torch.equal(out[s], k6.flash_mha(q[s], k[s], v[s], mask[s]))

    params = lightglue.load_params(WEIGHTS_DIR / "lightglue_superpoint.npz", device="cpu")
    desc = [torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(S, n, 256)).astype(np.float32)), dim=-1) for n in (K0, K1)]
    xy = [torch.from_numpy(rng.uniform(0, 320, (S, n, 2)).astype(np.float32)) for n in (K0, K1)]
    valid = [torch.from_numpy(rng.random((S, n)) < 0.8) for n in (K0, K1)]
    desc[1][:, :100] = desc[0][:, :100] + 0.05 * torch.from_numpy(
        rng.normal(size=(S, 100, 256)).astype(np.float32))  # pairs worth matching
    args = (desc[0], xy[0], valid[0], desc[1], xy[1], valid[1], (320.0, 240.0))
    scores = lightglue.assignment_scores(params, *args)
    matches = lightglue.match(params, *args, threshold=0.1)
    assert scores[0].shape == (S, K0, K1) and int(matches.valid.sum()) > 0
    for s in range(S):
        one = [a[s] if torch.is_tensor(a) else a for a in args]
        assert all(torch.equal(b[s], x) for b, x in
                   zip(scores, lightglue.assignment_scores(params, *one)))
        assert all(torch.equal(b[s], x) for b, x in
                   zip(matches, lightglue.match(params, *one, threshold=0.1)))


@pytest.mark.parametrize("masked", [False, True])
def test_superpoint_extract_batched_equals_per_frame(world, sp_params, masked):
    """(d)."""
    cam, seqs = world
    fe = _frontend(sp_params)
    imgs = torch.from_numpy(np.stack([seqs[0].frames[0], seqs[1].frames[3],
                                      seqs[0].frames[7]]).astype(np.float32))
    mask = None
    if masked:
        mask = torch.ones((cam.height, cam.width))
        mask[:, :100] = 0.0
    feats = fe.extract(imgs, mask)
    assert feats.desc.shape == (3, fe.num_keypoints(cam.height, cam.width), 256)
    for s in range(3):
        assert all(torch.equal(a[s], b) for a, b in zip(feats, fe.extract(imgs[s], mask)))
    if masked:
        assert (feats.xy[feats.valid][:, 0] >= 100).all()
