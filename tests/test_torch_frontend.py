"""Kernel K1's plain twin and the port's classical frontend against the JAX
package: the Pallas kernel in interpret mode and the XLA conv stack.

Tolerances are tests/test_frontend_fused.py's: response and NMS peaks
atol 2e-5 / rtol 1e-4, descriptor blur atol 1e-5 (float32 sums of up to 13
taps in another association order); keypoint validity agreement > 0.99 and
sub-pixel positions within 0.51 px for > 98 % (argmax flips at near-ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.ops import descriptors as jdesc
from racing_slam_tpu.ops import image as jimg
from racing_slam_tpu.ops.corners import max_pool_same, shi_tomasi_response
from racing_slam_tpu.ops.pallas.frontend_kernel import corner_frontend_fused
from racing_slam_tpu.slam.frontend import ClassicalFrontend as JaxFrontend
from racing_slam_tpu.utils.synthetic import random_texture
from racing_slam_tpu_torch.ops import descriptors as tdesc
from racing_slam_tpu_torch.ops import image as timg
from racing_slam_tpu_torch.ops.kernels.frontend import corner_frontend_fused_reference
from racing_slam_tpu_torch.slam.frontend import ClassicalFrontend

torch.set_num_threads(2)


def _mask(H, W):
    m = np.ones((H, W), np.float32)
    m[:, : W // 2] = 0
    m[: H // 8] = 0
    return m


def _xla_maps(img, mask=None, border=8, nms_radius=7):
    score = shi_tomasi_response(img)
    H, W = img.shape
    if mask is not None:
        score = jnp.where(mask > 0, score, 0.0)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = jnp.where(inb, score, 0.0)
    is_peak = score >= max_pool_same(score, 2 * nms_radius + 1)
    return score, jnp.where(is_peak, score, 0.0)


def _assert_maps(got, resp, peaks, blur):
    r, p, b = [x.numpy() for x in got]
    np.testing.assert_allclose(r, np.asarray(resp), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(p, np.asarray(peaks), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(b, np.asarray(blur), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_k1_twin_matches_pallas_interpret(rng, masked):
    img = random_texture(144, 256, rng)
    m = _mask(144, 256) if masked else None
    got = corner_frontend_fused_reference(torch.from_numpy(img),
                                          None if m is None else torch.from_numpy(m))
    want = corner_frontend_fused(jnp.asarray(img), None if m is None else jnp.asarray(m),
                                 interpret=True)
    _assert_maps(got, *want)
    if masked:
        assert got[0].numpy()[m == 0].max() == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_k1_twin_matches_xla_stack(rng, masked):
    img = random_texture(96, 128, rng)
    m = _mask(96, 128) if masked else None
    got = corner_frontend_fused_reference(torch.from_numpy(img),
                                          None if m is None else torch.from_numpy(m))
    jm = None if m is None else jnp.asarray(m)
    score, peaks = _xla_maps(jnp.asarray(img), jm)
    _assert_maps(got, score, peaks, jimg.gaussian_blur(jnp.asarray(img), 2.0))


@pytest.mark.parametrize("op", ["sobel", "box", "max_pool", "bilinear"])
def test_image_ops_match_jax(rng, op):
    img = random_texture(48, 64, rng)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    if op == "sobel":
        got, want = timg.sobel_gradients(t), jimg.sobel_gradients(j)
    elif op == "box":
        got, want = [timg.box_filter(t, 3)], [jimg.box_filter(j, 3)]
    elif op == "max_pool":
        got, want = [timg.max_pool_same(t, 15)], [jimg.max_pool_same(j, 15)]
    else:
        xy = rng.uniform(-2, 70, (200, 2)).astype(np.float32)
        got = [timg.bilinear_sample(t, torch.from_numpy(xy))]
        want = [jimg.bilinear_sample(j, jnp.asarray(xy))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_descriptor_projection_is_bit_identical():
    np.testing.assert_array_equal(tdesc._PROJ, jdesc._PROJ)


def test_extract_matches_jax_frontend(rng):
    """Keypoints as test_frontend_fused.py:60-75; descriptors compared where
    the two frontends put a keypoint at the same position."""
    img = random_texture(144, 256, rng)
    got = ClassicalFrontend().extract(torch.from_numpy(img))
    want = JaxFrontend(backend="xla").extract(jnp.asarray(img))
    vx, vt = np.asarray(want.valid), got.valid.numpy()
    assert (vx == vt).mean() > 0.99
    both = vx & vt
    dxy = np.abs(np.asarray(want.xy)[both] - got.xy.numpy()[both]).max(axis=-1)
    assert (dxy < 0.51).mean() > 0.98
    same = np.zeros_like(both)
    same[np.nonzero(both)[0][dxy < 1e-4]] = True
    assert same.sum() > 0.9 * both.sum()
    # Float32 patch sums and the 256x128 projection in another order.
    np.testing.assert_allclose(got.desc.numpy()[same], np.asarray(want.desc)[same], atol=1e-4)


def test_descriptors_take_a_frame_batch(rng):
    imgs = np.stack([random_texture(96, 128, rng) for _ in range(3)])
    fe = ClassicalFrontend()
    feats = [fe.extract(torch.from_numpy(i)) for i in imgs]
    xy = torch.stack([f.xy for f in feats])
    batch = tdesc.extract_descriptors_cells(torch.from_numpy(imgs), xy, 16, 2)
    assert batch.shape == (3, xy.shape[1], 128)
    for b, f in enumerate(feats):
        np.testing.assert_allclose(batch[b].numpy(), f.desc.numpy(), atol=1e-5)
