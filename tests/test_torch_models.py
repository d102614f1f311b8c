"""The learned path of the port against the JAX package, on the CPU.

Each test feeds the same numpy inputs (made from a seed) to both packages.

- K6's plain twin (ops/kernels/attention.py) against the JAX Pallas kernel
  flash_mha in interpret mode: both round q, k, v and p to bf16 and sum in
  float32 over the same 512-key tiles, so they differ by float32 summation
  order and a rare flip in the bf16 rounding of p: atol 1e-3.
- LightGlue (models/lightglue.py) against JAX assignment_scores/match with
  the Pallas kernel in interpret mode (the same attention arithmetic):
  scores to atol 2e-4, matchability to 1e-3 (float32 matmuls in another
  order move a bf16 rounding of q, k or v now and then; two layers of
  random weights amplify it). Against JAX's dense f32 attention ("xla")
  at the tolerance tests/test_models.py:236-239 uses between its two
  backends.
- The committed LightGlue weights, converted leaf by leaf: mutual matches
  agree with JAX's default (f32) attention on >= 98 % of the keypoints.
- SuperPoint (models/superpoint.py) on the committed weights, a 320x240
  frame: heatmap and descriptor map within bf16 tolerances, keypoints at
  the same position on >= 99 %.
- The learned path through Slam (SuperPoint + LightGlue on the 256-d
  weights, picked by descriptor dimension), its weight checks, and the
  card-by-default rule of the new entry points.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.models import lightglue as jlg
from racing_slam_tpu.models import superpoint as jsp
from racing_slam_tpu.ops.pallas.attention_kernel import flash_mha as jax_flash_mha
from racing_slam_tpu.slam import state as jstate
from racing_slam_tpu_torch.models import lightglue as tlg
from racing_slam_tpu_torch.models import superpoint as tsp
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.ops.kernels.attention import flash_mha, flash_mha_reference
from racing_slam_tpu_torch.slam.config import SlamConfig
from racing_slam_tpu_torch.slam.frontend import LightGlueMatcher
from racing_slam_tpu_torch.slam.pipeline import Slam
from racing_slam_tpu_torch.utils.convert import (
    lightglue_params_from_numpy,
    state_from_numpy,
    superpoint_params_from_numpy,
)
from racing_slam_tpu_torch.utils.metrics import ate_rmse
from racing_slam_tpu_torch.utils.synthetic import make_sequence
from racing_slam_tpu_torch.utils.video import ArraySource

torch.set_num_threads(2)
WEIGHTS = Path(__file__).resolve().parents[1] / "racing_slam_tpu" / "weights"


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K6 twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [0.8, 0.0])
def test_flash_mha_twin_matches_jax_kernel(valid):
    rng = np.random.default_rng(6)
    Kq, Kk, H, dh = 200, 333, 4, 32
    q, k, v = [rng.normal(size=(n, H, dh)).astype(np.float32) for n in (Kq, Kk, Kk)]
    mask = rng.random(Kk) < valid
    want = np.asarray(jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), interpret=True))
    got = flash_mha(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    if valid == 0.0:  # every key masked: the mean of the bf16-rounded values
        vb = _t(v).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, np.broadcast_to(vb.mean(0), got.shape), atol=1e-5)


@pytest.mark.parametrize("Kk,valid", [(2400, 0.8), (2400, 0.0), (2333, 0.8)])
def test_k6_card_tolerance_separates_rounding_from_a_dropped_tile(Kk, valid):
    """chip_smoke.py holds K6 to 5 % of the twin's output RMS. The kernel's
    only rounding difference from the twin is its 64-key tiles (p rounded
    to bf16 against another running max), which the twin reproduces at
    tile_k=64: that stays within 1 % of the RMS. A kernel that skipped the
    last partial tile (or, at 2400, the last 32 keys) exceeds the limit 5x."""
    rng = np.random.default_rng(9)
    Kq, H, dh = 600, 4, 32
    q, k, v = [_t(rng.normal(size=(n, H, dh)).astype(np.float32)) for n in (Kq, Kk, Kk)]
    mask = _t(rng.random(Kk) < valid)
    want = flash_mha(q, k, v, mask)
    limit = 0.05 * float(want.pow(2).mean().sqrt())
    tiles64 = flash_mha_reference(q, k, v, mask, tile_k=64)
    assert float((tiles64 - want).abs().max()) <= 0.2 * limit
    n = (Kk - 1) // 64 * 64
    dropped = flash_mha_reference(q, k[:n], v[:n], mask[:n], tile_k=64)
    assert float((dropped - want).abs().max()) >= 5 * limit


@pytest.mark.parametrize("valid,chunks", [(0.8, 3), (0.0, 3), (0.8, 8)])
def test_split_twin_matches_jax_kernel(valid, chunks):
    """The twin at the CUDA kernel's 64-key tiles and split into `chunks`
    key runs (8 runs of 64 at 333 keys: the last three hold only padding)
    against the JAX kernel in interpret mode, within the card's limit of
    5 % of the output RMS (chip_smoke.py check_attention)."""
    rng = np.random.default_rng(6)
    Kq, Kk, H, dh = 200, 333, 4, 32
    q, k, v = [rng.normal(size=(n, H, dh)).astype(np.float32) for n in (Kq, Kk, Kk)]
    mask = rng.random(Kk) < valid
    want = np.asarray(jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), interpret=True))
    got = flash_mha_reference(_t(q), _t(k), _t(v), _t(mask), tile_k=64, chunks=chunks).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.05 * np.sqrt(np.mean(want**2)), rtol=0)
    if valid == 0.0:  # uniform over the masked keys, through the combine
        vb = _t(v).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, np.broadcast_to(vb.mean(0), got.shape), atol=1e-5)


@pytest.mark.parametrize("Kk,valid,chunks", [(2400, 0.8, 4), (2400, 0.0, 4), (2333, 0.8, 4),
                                             (2400, 0.8, 20)])
def test_k6_card_tolerance_separates_the_split_from_a_dropped_chunk(Kk, valid, chunks):
    """The kernel's split of the keys and its combine, modelled by the
    twin, stay within half the card's limit of the unsplit twin (measured:
    at most 0.22 of it); a combine that dropped the last chunk holding keys
    exceeds the limit at least 5x. At 2400 keys in 20 chunks of 128 the
    last chunk holds only padding."""
    rng = np.random.default_rng(9)
    Kq, H, dh = 600, 4, 32
    q, k, v = [_t(rng.normal(size=(n, H, dh)).astype(np.float32)) for n in (Kq, Kk, Kk)]
    mask = _t(rng.random(Kk) < valid)
    want = flash_mha_reference(q, k, v, mask)
    limit = 0.05 * float(want.pow(2).mean().sqrt())
    split = flash_mha_reference(q, k, v, mask, tile_k=64, chunks=chunks)
    assert float((split - want).abs().max()) <= 0.5 * limit
    run = -(-Kk // (chunks * 64)) * 64
    last = (Kk - 1) // run  # the last chunk that holds keys
    dropped = flash_mha_reference(q, k[: last * run], v[: last * run], mask[: last * run],
                                  tile_k=64, chunks=last)
    assert float((dropped - want).abs().max()) >= 5 * limit


# ---------------------------------------------------------------------------
# LightGlue
# ---------------------------------------------------------------------------


def _lg_inputs(rng, K0, K1, D):
    d0 = rng.normal(size=(K0, D)).astype(np.float32)
    d1 = rng.normal(size=(K1, D)).astype(np.float32)
    xy0 = rng.uniform(0, 320, size=(K0, 2)).astype(np.float32)
    xy1 = rng.uniform(0, 320, size=(K1, 2)).astype(np.float32)
    return d0, xy0, rng.random(K0) < 0.9, d1, xy1, rng.random(K1) < 0.9


@pytest.fixture(scope="module")
def small_lightglue():
    params = jlg.init_params(jax.random.PRNGKey(1), in_dim=32, dim=64, n_layers=2)
    ours = lightglue_params_from_numpy(_leaves(params), 32, 64, 2, device="cpu")
    return params, ours, _lg_inputs(np.random.default_rng(3), 96, 128, 32)


@pytest.mark.parametrize("backend,atol,rtol,atol_m", [
    ("pallas_interpret", 2e-4, 0.0, 1e-3),
    ("xla", 3e-2, 5e-2, 2e-2),
])
def test_assignment_scores_match_jax(small_lightglue, backend, atol, rtol, atol_m):
    params, ours, inputs = small_lightglue
    want = jlg.assignment_scores(params, *map(jnp.asarray, inputs), (320.0, 240.0),
                                 attn_backend=backend)
    got = tlg.assignment_scores(ours, *map(_t, inputs), (320.0, 240.0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol, rtol=rtol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol_m)


def test_match_matches_jax(small_lightglue):
    params, ours, inputs = small_lightglue
    want = jlg.match(params, *map(jnp.asarray, inputs), (320.0, 240.0), threshold=0.0,
                     attn_backend="pallas_interpret")
    got = tlg.match(ours, *map(_t, inputs), (320.0, 240.0), threshold=0.0)
    np.testing.assert_array_equal(got.train_idx.numpy(), np.asarray(want.train_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance), atol=1e-4)


@pytest.mark.parametrize("name", ["lightglue_superpoint.npz", "lightglue.npz"])
def test_committed_lightglue_weights_match_jax(name):
    """Features of two 320x240 frames (K=600) from the JAX frontend that
    each weight file was trained for: SuperPoint for the 256-d weights, the
    classical frontend for the 128-d ones. Mutual matches at the pipeline's
    threshold agree with JAX's default (f32) attention on >= 98 % of the
    keypoints: the port's attention is bf16, as the TPU kernel's."""
    from racing_slam_tpu.ops.camera import Camera as JaxCamera
    from racing_slam_tpu.slam.frontend import ClassicalFrontend as JaxClassical
    from racing_slam_tpu.utils.synthetic import make_sequence as jax_make_sequence

    jparams = jlg.load_params(WEIGHTS / name)
    ours = tlg.load_params(WEIGHTS / name, device="cpu")
    assert tuple(ours.in_proj_w.shape) == tuple(jparams.in_proj_w.shape)
    assert len(ours.layers) == len(jparams.layers)
    cam = JaxCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
    seq = jax_make_sequence(np.random.default_rng(5), n_frames=3, cam=cam, n_sprites=140,
                            step_t=np.array([0.10, 0.01, 0.16], np.float32))
    fe = (jsp.SuperPointFrontend(params=jsp.load_params(WEIGHTS / "superpoint.npz"))
          if name == "lightglue_superpoint.npz" else JaxClassical())
    f0, f1 = [fe.extract(jnp.asarray(seq.frames[i])) for i in (0, 2)]
    inputs = [np.asarray(x) for x in (f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid)]
    want = jlg.match(jparams, *map(jnp.asarray, inputs), (320.0, 240.0), threshold=0.35)
    got = tlg.match(ours, *map(_t, inputs), (320.0, 240.0), threshold=0.35)
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    wi, gi = np.asarray(want.train_idx), got.train_idx.numpy()
    same = (wv == gv) & (~wv | (wi == gi))
    assert wv.sum() > 100
    assert same.mean() >= 0.98, same.mean()


# ---------------------------------------------------------------------------
# SuperPoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def superpoint():
    jparams = jsp.load_params(WEIGHTS / "superpoint.npz")
    ours = tsp.load_params(WEIGHTS / "superpoint.npz", device="cpu")
    cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
    seq = make_sequence(np.random.default_rng(3), n_frames=1, cam=cam, n_sprites=140)
    return jparams, ours, seq.frames[0].astype(np.float32)


def test_superpoint_params_convert():
    p = jsp.init_params(jax.random.PRNGKey(4))
    ours = superpoint_params_from_numpy(_leaves(p), device="cpu")
    assert len(jax.tree_util.tree_leaves(p)) == 24
    for a, b in zip(p.conv_w + p.det_w + p.desc_w, ours.conv_w + ours.det_w + ours.desc_w):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).transpose(3, 2, 0, 1))
    for a, b in zip(p.conv_b + p.det_b + p.desc_b, ours.conv_b + ours.det_b + ours.desc_b):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_superpoint_maps_match_jax(superpoint):
    """Both sides convolve bf16-rounded operands with float32 sums, in
    another order, so a layer's input may round to the neighbouring bf16
    value now and then (2^-8 relative), and the difference grows through
    the 10 layers: the heatmap (probabilities) agrees to 1e-3 on >= 99.5 %
    of the pixels and to 1.5e-2 everywhere; unit descriptors to 1e-2, with
    a median error below 1e-4."""
    jparams, ours, img = superpoint
    feat = jsp.backbone(jparams, jnp.asarray(img), compute_dtype=jnp.bfloat16)
    jheat, jdesc = jsp.heads(jparams, feat, compute_dtype=jnp.bfloat16)
    heat, desc = tsp.heads(ours, tsp.backbone(ours, _t(img)))
    assert heat.shape == (240, 320) and desc.shape == (30, 40, 256)
    herr = np.abs(heat.numpy() - np.asarray(jheat))
    assert herr.max() < 1.5e-2 and np.mean(herr < 1e-3) >= 0.995, (herr.max(), np.mean(herr < 1e-3))
    err = np.abs(desc.numpy() - np.asarray(jdesc))
    assert err.max() < 1e-2 and np.median(err) < 1e-4, (err.max(), np.median(err))


@pytest.mark.parametrize("masked", [False, True])
def test_superpoint_extract_matches_jax(superpoint, masked):
    """Keypoints: the same pixel and sub-pixel position (within 0.05 px: the
    parabola fit divides heatmap differences) on >= 99 %; validity on
    >= 99 %; scores to 1.5e-2 and descriptors to 2e-2 (maps above) where
    the keypoints agree."""
    jparams, ours, img = superpoint
    mask = np.ones((240, 320), np.float32)
    mask[:, :100] = 0.0
    jfe = jsp.SuperPointFrontend(params=jparams)
    tfe = tsp.SuperPointFrontend(params=ours, device="cpu")
    want = jfe.extract(jnp.asarray(img), jnp.asarray(mask) if masked else None)
    got = tfe.extract(_t(img), _t(mask) if masked else None)
    xy, wxy = got.xy.numpy(), np.asarray(want.xy)
    same = np.all(np.abs(xy - wxy) < 0.05, axis=-1)
    assert same.mean() >= 0.99, same.mean()
    assert (got.valid.numpy() == np.asarray(want.valid)).mean() >= 0.99
    np.testing.assert_allclose(got.score.numpy()[same], np.asarray(want.score)[same], atol=1.5e-2)
    np.testing.assert_allclose(got.desc.numpy()[same], np.asarray(want.desc)[same], atol=2e-2)
    if masked:
        assert (xy[got.valid.numpy()][:, 0] >= 100).all()


# ---------------------------------------------------------------------------
# The learned path through Slam
# ---------------------------------------------------------------------------


def _cam():
    return Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)


def _cfg(**kw):
    base = dict(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                cull_points=True, max_keyframes=8, map_capacity=1024, max_observations=4,
                ba_iters=4, motion_ba_iters=4, ransac_hypotheses=128, reinit_on_lost=False)
    return SlamConfig(**{**base, **kw})


def test_learned_path_tracks():
    """tests/test_lightglue_pipeline.py:124-151 on the port: SuperPoint
    (committed weights) feeding LightGlue, whose 256-d weights Slam picks by
    the descriptor dimension; the same bar."""
    cam = _cam()
    seq = make_sequence(np.random.default_rng(3), n_frames=10, cam=cam, n_sprites=140,
                        step_t=np.array([0.10, 0.01, 0.16], np.float32))
    fe = tsp.SuperPointFrontend(params=tsp.load_params(WEIGHTS / "superpoint.npz", device="cpu"),
                                device="cpu")
    slam = Slam(cam, ArraySource(seq.frames), _cfg(matcher="lightglue", lightglue_threshold=0.2),
                frontend=fe, device="cpu")
    assert isinstance(slam.frontend.matcher, LightGlueMatcher)
    assert slam.frontend.matcher.params.in_proj_w.shape[0] == fe.descriptor_dim == 256
    assert slam.state.obs_desc.shape[-1] == 256
    assert slam.initialize(), "bootstrap failed with the learned path"
    slam.run()
    kf_idx = slam.keyframe_indices()
    ate = ate_rmse(slam.poses(), seq.poses[kf_idx])
    length = float(np.linalg.norm(seq.poses[-1][:3, 3] - seq.poses[0][:3, 3]))
    assert int(slam.state.num_kf) >= 2
    assert np.isfinite(ate) and ate < 0.3 * max(length, 1.0)
    assert slam.host_syncs["track"] == slam.frames_tracked


def test_lightglue_variant_tracks():
    """The classical frontend with LightGlue on the 128-d weights (the
    `lightglue` bench variant); the bar of
    tests/test_lightglue_pipeline.py:71-86 (under 10 % of the length)."""
    cam = _cam()
    seq = make_sequence(np.random.default_rng(11), n_frames=14, cam=cam, n_sprites=160,
                        step_t=np.array([0.10, 0.01, 0.16], np.float32))
    slam = Slam(cam, ArraySource(seq.frames), _cfg(matcher="lightglue"), device="cpu")
    assert slam.frontend.matcher.params.in_proj_w.shape[0] == 128
    assert slam.initialize()
    slam.run()
    kf_idx = slam.keyframe_indices()
    ate = ate_rmse(slam.poses(), seq.poses[kf_idx])
    length = float(np.linalg.norm(seq.poses[-1][:3, 3] - seq.poses[0][:3, 3]))
    assert int(slam.state.num_kf) >= 2
    assert ate < 0.1 * max(length, 1.0)


def test_mismatched_lightglue_weights_raise():
    """128-d LightGlue weights with the 256-d SuperPoint frontend fail at
    construction (tests/test_lightglue_pipeline.py:154-164)."""
    fe = tsp.SuperPointFrontend(tsp.load_params(WEIGHTS / "superpoint.npz", device="cpu"),
                                device="cpu")
    with pytest.raises(ValueError, match="descriptors"):
        Slam(_cam(), ArraySource([]), _cfg(matcher="lightglue",
                                           lightglue_weights=str(WEIGHTS / "lightglue.npz")),
             frontend=fe, device="cpu")


@pytest.mark.parametrize("entry", ["superpoint_frontend", "superpoint_load", "lightglue_load",
                                   "lightglue_matcher", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without a card, the learned path's entry points and the state
    converter raise unless given device="cpu"; with device="cpu" they build."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    make = {
        "superpoint_frontend": lambda **kw: tsp.SuperPointFrontend(
            tsp.load_params(WEIGHTS / "superpoint.npz", device="cpu"), **kw),
        "superpoint_load": lambda **kw: tsp.load_params(WEIGHTS / "superpoint.npz", **kw),
        "lightglue_load": lambda **kw: tlg.load_params(WEIGHTS / "lightglue.npz", **kw),
        "lightglue_matcher": lambda **kw: LightGlueMatcher(
            tlg.load_params(WEIGHTS / "lightglue.npz", device="cpu"), (320.0, 240.0), **kw),
        "state_from_numpy": lambda **kw: state_from_numpy(jax.tree.map(
            np.asarray, jstate.SlamState.create(F=2, P=8, O=2, K=4, D=8, A=2)), **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None
