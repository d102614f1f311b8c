"""Training (racing_slam_tpu_torch/models/train.py) against the JAX package's,
on the CPU.

Each check feeds the same numpy inputs (made from a seed) to both packages;
the port's parameters are converted from JAX's `init_params`. JAX trains
on its default ("auto") attention route, which the port's
`attn_backend="xla_flash"` computes; neither reaches a kernel.

- The host code (homographies, warps, photometric jitter, the image pool)
  is numpy in both: equal to the bit, the generators left in the same state.
- `_detector_labels`: 0 cells of three 64x64 textures differ.
- Losses and gradients, float32 on both sides in another summation order:
  each loss within 1e-5 relative, each gradient leaf within 1e-4 of that
  leaf's largest magnitude (measured: 1e-7 and 3e-6).
- Adam with optax's cosine decay: LightGlue parameters after 3 steps on the
  same batches within 1e-3 of the learning rate (measured 1.3e-4). Adam
  normalises each element by its own gradient, so an element whose
  gradient is float noise moves by up to the learning rate either way:
  SuperPoint's parameters after 3 such steps differ by up to 1.5x the rate
  on 0.5 % of the elements, so its case feeds JAX's gradients to both
  optimizers and holds the parameters to 1e-3 of the rate.
- `init_params`: the JAX tree and shapes (kernels HWIO <-> OIHW), each
  leaf's std within 10 % of JAX's, biases zero, one seed one draw.
- `save_params` / `load_params` both ways, bit-equal.
- The JAX package's own training tests (tests/test_models.py) on the port,
  at their thresholds, and the command line writing a file JAX reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from racing_slam_tpu.models import lightglue as jlg
from racing_slam_tpu.models import superpoint as jsp
from racing_slam_tpu.models import train as jt
from racing_slam_tpu_torch.models import lightglue as tlg
from racing_slam_tpu_torch.models import superpoint as tsp
from racing_slam_tpu_torch.models import train as tt
from racing_slam_tpu_torch.slam.frontend import ClassicalFrontend
from racing_slam_tpu_torch.slam.state import tree_map
from racing_slam_tpu_torch.utils.convert import (
    lightglue_params_from_numpy,
    lightglue_params_to_numpy,
    superpoint_params_from_numpy,
    superpoint_params_to_numpy,
    tree_leaves,
)
from racing_slam_tpu_torch.utils.synthetic import random_texture

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
PARAM_TOL = 1e-3  # of the learning rate


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _j(batch):
    return [jnp.asarray(t.numpy()) for t in batch]


class _Pool:
    """A few textures behind `_ImagePool`'s sampling (a pool of 300
    renders costs ~16 s of CPU)."""

    def __init__(self, rng, h, w, n=3):
        self.images = [random_texture(h, w, rng) for _ in range(n)]
        self.rng = rng

    def sample(self):
        return self.images[self.rng.integers(len(self.images))]


def _sp_batches(n, h=64, w=64, n_corr=32, seed=1):
    rng = np.random.default_rng(seed)
    pool = _Pool(rng, h, w)
    return [tt._superpoint_batch(rng, pool, h, w, n_corr, "cpu") for _ in range(n)]


def _sp_params(seed=0):
    jp = jsp.init_params(jax.random.PRNGKey(seed))
    return jp, superpoint_params_from_numpy(_leaves(jp), device="cpu")


def _lg_params(in_dim, dim, n_layers, seed=0):
    jp = jlg.init_params(jax.random.PRNGKey(seed), in_dim, dim, n_layers)
    return jp, lightglue_params_from_numpy(_leaves(jp), in_dim, dim, n_layers, device="cpu")


def _assert_grads(jgrads, ours, to_numpy):
    got = to_numpy(tree_map(lambda t: t.grad, ours))
    for i, (g, w) in enumerate(zip(got, _leaves(jgrads), strict=True)):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, (i, np.abs(g - w).max(), scale)


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------


def _host(mod, name, rng):
    img = random_texture(48, 64, np.random.default_rng(9))
    H = mod.random_homography(np.random.default_rng(8), 48, 64)
    if name == "random_homography":
        return [mod.random_homography(rng, 48, 64, mag=0.2)]
    if name == "warp_image":
        return [mod.warp_image(img, H)]
    if name == "apply_h":
        return [mod.apply_h(H, rng.uniform(0, 64, (50, 2)).astype(np.float32))]
    if name == "photometric":
        return [mod._photometric(img, rng)]
    pool = mod._ImagePool(rng, 48, 64, size=6)
    return [*pool.images, pool.sample(), pool.sample()]


@pytest.mark.parametrize("name", ["random_homography", "warp_image", "apply_h", "photometric",
                                  "image_pool"])
def test_host_helpers_equal_jax(name):
    r_t, r_j = np.random.default_rng(4), np.random.default_rng(4)
    for got, want in zip(_host(tt, name, r_t), _host(jt, name, r_j), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert r_t.random() == r_j.random()  # the same numbers drawn


def test_detector_labels_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(3):
        img = random_texture(64, 64, rng)
        want = np.asarray(jt._detector_labels(jnp.asarray(img)))
        got = tt._detector_labels(torch.from_numpy(img)).numpy()
        assert got.shape == (8, 8) and (want < 64).any()
        assert int((got != want).sum()) == 0


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------


def test_superpoint_loss_and_grads_match_jax():
    batch = _sp_batches(1)[0]
    jp, ours = _sp_params()
    ours = tt._trainable(ours)
    want, jgrads = jax.jit(jax.value_and_grad(jt.superpoint_loss))(jp, *_j(batch))
    loss = tt.superpoint_loss(ours, *batch)
    loss.backward()
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    _assert_grads(jgrads, ours, superpoint_params_to_numpy)


def _lg_case(name):
    rng = np.random.default_rng(3)
    d0, xy0, d1, xy1, gt_idx, gt_valid = tt._toy_batch(rng, 32, 32, 0.25, "cpu")
    if name == "lightglue_loss":
        return (d0, xy0, d1, xy1, gt_idx, gt_valid)
    v0, v1 = torch.from_numpy(rng.random(32) < 0.8), torch.from_numpy(rng.random(32) < 0.8)
    return (d0, xy0, v0, d1, xy1, v1, gt_idx, gt_valid)


@pytest.mark.parametrize("name", ["lightglue_loss", "lightglue_frontend_loss"])
def test_lightglue_losses_and_grads_match_jax(name):
    args = _lg_case(name)
    jp, ours = _lg_params(32, 32, 1)
    ours = tt._trainable(ours)
    size = (128.0, 128.0)
    fn = getattr(jt, name)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p, *a: fn(p, *a, size)))(jp, *_j(args))
    loss = getattr(tt, name)(ours, *args, size)
    loss.backward()
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    _assert_grads(jgrads, ours, lightglue_params_to_numpy)


def test_xla_flash_scores_match_jax():
    """The float32 route against JAX's "xla_flash" (its training route) at
    two layers, with masked keypoints: float32 on both sides."""
    rng = np.random.default_rng(5)
    K0, K1, D = 40, 56, 32
    inputs = (rng.normal(size=(K0, D)).astype(np.float32),
              rng.uniform(0, 320, (K0, 2)).astype(np.float32), rng.random(K0) < 0.8,
              rng.normal(size=(K1, D)).astype(np.float32),
              rng.uniform(0, 320, (K1, 2)).astype(np.float32), rng.random(K1) < 0.8)
    jp, ours = _lg_params(D, 64, 2, seed=1)
    want = jax.jit(jlg.assignment_scores, static_argnums=(7, 8))(
        jp, *map(jnp.asarray, inputs), (320.0, 240.0), "xla_flash")
    got = tlg.assignment_scores(ours, *map(torch.from_numpy, inputs), (320.0, 240.0),
                                attn_backend="xla_flash")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# Adam and the cosine schedule against optax
# ---------------------------------------------------------------------------


def _superpoint_adam():
    """3 updates of SuperPoint from JAX's gradients along JAX's run (see the
    module docstring), on both optimizers."""
    lr, steps = 1e-3, 3
    jp, ours = _sp_params()
    ours = tt._trainable(ours)
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))
    state = opt.init(jp)
    topt, sched = tt._adam(ours, lr, decay_steps=steps)
    grad_fn = jax.jit(jax.grad(jt.superpoint_loss))
    for batch in _sp_batches(steps):
        g = grad_fn(jp, *_j(batch))
        grads = superpoint_params_from_numpy(_leaves(g), device="cpu")
        for t, a in zip(tree_leaves(ours), tree_leaves(grads)):
            t.grad = a
        topt.step()
        sched.step()
        updates, state = opt.update(g, state)
        jp = optax.apply_updates(jp, updates)
    return lr, _leaves(jp), superpoint_params_to_numpy(ours)


def _lightglue_adam():
    """3 steps of the LightGlue toy loss, each package on its own gradients."""
    lr, steps, size = 1e-3, 3, (128.0, 128.0)
    jp, ours = _lg_params(32, 32, 1)
    ours = tt._trainable(ours)
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))
    state = opt.init(jp)
    topt, sched = tt._adam(ours, lr, decay_steps=steps)

    @jax.jit
    def jstep(p, s, *batch):
        g = jax.grad(jt.lightglue_loss)(p, *batch, size)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s

    rng = np.random.default_rng(0)
    for _ in range(steps):
        batch = tt._toy_batch(rng, 32, 32, 0.25, "cpu")
        jp, state = jstep(jp, state, *_j(batch))
        tt._step(topt, sched, tt.lightglue_loss(ours, *batch, size))
    return lr, _leaves(jp), lightglue_params_to_numpy(ours)


@pytest.mark.parametrize("net", ["lightglue", "superpoint"])
def test_adam_cosine_matches_optax(net):
    lr, want, got = (_lightglue_adam if net == "lightglue" else _superpoint_adam)()
    moved = 0.0
    for g, w in zip(got, want, strict=True):
        assert float(np.abs(g - w).max()) <= PARAM_TOL * lr
        moved = max(moved, float(np.abs(w).max()))
    assert moved > 0.0


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(2e-4, 7, alpha=0.02)
    for c in range(10):
        assert abs(2e-4 * tt._cosine_decay(c, 7) - float(sched(c))) <= 1e-6 * 2e-4


# ---------------------------------------------------------------------------
# init_params and save_params
# ---------------------------------------------------------------------------


def _init(net, seed, package):
    if package == "jax":
        key = jax.random.PRNGKey(seed)
        p = jsp.init_params(key) if net == "superpoint" else jlg.init_params(key, 128, 128, 2)
        return _leaves(p)
    gen = torch.Generator().manual_seed(seed)
    if net == "superpoint":
        return superpoint_params_to_numpy(tsp.init_params(gen, device="cpu"))
    return lightglue_params_to_numpy(tlg.init_params(gen, 128, 128, 2, device="cpu"))


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_init_params_match_jax(net):
    ours, again, other = _init(net, 0, "torch"), _init(net, 0, "torch"), _init(net, 1, "torch")
    want = _init(net, 0, "jax")
    assert len(ours) == len(want)
    for a, b, c, w in zip(ours, again, other, want):
        assert a.shape == w.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        if not np.any(w):
            assert not np.any(a)  # the biases
            continue
        assert not np.array_equal(a, c)
        assert abs(a.std() / w.std() - 1.0) <= 0.10, (a.shape, a.std(), w.std())


def test_superpoint_frontend_without_params_draws_init_params():
    fe = tsp.SuperPointFrontend(seed=3, device="cpu")
    want = tsp.init_params(torch.Generator().manual_seed(3), device="cpu")
    for a, b in zip(tree_leaves(fe.params), tree_leaves(want)):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)
    assert fe.descriptor_dim == 256


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_params_round_trip_with_jax(tmp_path, net, writer):
    path = tmp_path / "w.npz"
    jmod, tmod = (jsp, tsp) if net == "superpoint" else (jlg, tlg)
    to_numpy = superpoint_params_to_numpy if net == "superpoint" else lightglue_params_to_numpy
    if writer == "torch":
        gen = torch.Generator().manual_seed(2)
        params = (tsp.init_params(gen, device="cpu") if net == "superpoint"
                  else tlg.init_params(gen, 64, 32, 1, device="cpu"))
        tmod.save_params(path, params)
        want = to_numpy(params)
    else:
        key = jax.random.PRNGKey(2)
        params = jsp.init_params(key) if net == "superpoint" else jlg.init_params(key, 64, 32, 1)
        jmod.save_params(path, params)
        want = _leaves(params)
    for got in (_leaves(jmod.load_params(path)), to_numpy(tmod.load_params(path, device="cpu"))):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The JAX package's training tests, on the port
# ---------------------------------------------------------------------------


def test_train_smoke():
    """A few optimisation steps run and leave finite weights
    (tests/test_models.py:109)."""
    sp = tt.train_superpoint(steps=2, img_size=(64, 64), n_corr=32, log_every=0, device="cpu")
    assert all(torch.isfinite(t).all() for t in tree_leaves(sp))
    assert not any(t.requires_grad for t in tree_leaves(sp))
    lg = tt.train_lightglue(steps=2, K=32, dim=32, n_layers=1, log_every=0, device="cpu")
    assert all(torch.isfinite(t).all() for t in tree_leaves(lg))


def _permutation_match_stats(params, n_pairs=3, K=48, dim=32, noise=0.35, seed=123):
    r = np.random.default_rng(seed)
    hits, total = 0, 0
    for _ in range(n_pairs):
        d0 = r.standard_normal((K, dim)).astype(np.float32)
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        xy0 = r.uniform(0, 128, (K, 2)).astype(np.float32)
        perm = r.permutation(K)
        d1 = d0[perm] + noise * r.standard_normal((K, dim)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        ones = torch.ones(K, dtype=torch.bool)
        m = tlg.match(params, torch.from_numpy(d0), torch.from_numpy(xy0), ones,
                      torch.from_numpy(d1), torch.from_numpy(xy0[perm]), ones,
                      image_size=(128.0, 128.0), threshold=0.05)
        v = m.valid.numpy()
        ti = m.train_idx.numpy()
        hits += int((ti[v] == perm[v]).sum())
        total += int(v.sum())
    return hits, total


def test_lightglue_training_improves_matching():
    """600 steps lift correct matches far above the untrained network's, at
    tests/test_models.py:144's thresholds (matching through K6's twin)."""
    untrained = tlg.init_params(torch.Generator().manual_seed(5), 32, 32, 1, device="cpu")
    hits_u, _ = _permutation_match_stats(untrained)
    params = tt.train_lightglue(steps=600, K=48, dim=32, n_layers=1, noise=0.35, log_every=0,
                                seed=5, lr=2e-3, device="cpu")
    hits_t, total_t = _permutation_match_stats(params)
    assert total_t >= 20
    assert hits_t > max(3 * hits_u, 15), (hits_u, hits_t, total_t)


def test_main_writes_weights_jax_reads(tmp_path, capsys):
    report = tt.main(["--which", "lightglue-toy", "--cpu", "--steps", "2", "--out",
                      str(tmp_path)])
    out = capsys.readouterr().out
    assert "lightglue step 0: loss" in out and "steps/s" in out
    # What it printed, returned: the one logged loss and the rate.
    (loss,) = report["lightglue_toy"]["losses"]
    assert f"lightglue step 0: loss {loss:.4f}" in out and np.isfinite(loss)
    assert f"{report['lightglue_toy']['steps_per_s']:.3f} steps/s" in out
    params = jlg.load_params(tmp_path / "lightglue_toy.npz")
    assert params.in_proj_w.shape == (64, 64) and len(params.layers) == 2
    assert all(np.isfinite(x).all() for x in _leaves(params))


@pytest.mark.parametrize("entry", ["train_superpoint", "train_lightglue",
                                   "train_lightglue_frontend", "train_lightglue_superpoint",
                                   "train_lightglue_on_frontend", "superpoint_init",
                                   "lightglue_init",
                                   "main"])
def test_training_entry_points_need_a_card(entry):
    """Without a card, training raises unless asked for the CPU, before any
    image is rendered."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    gen = torch.Generator()
    call = {
        "train_superpoint": lambda: tt.train_superpoint(steps=1),
        "train_lightglue": lambda: tt.train_lightglue(steps=1),
        "train_lightglue_frontend": lambda: tt.train_lightglue_frontend(steps=1),
        "train_lightglue_superpoint": lambda: tt.train_lightglue_superpoint(steps=1),
        "train_lightglue_on_frontend": lambda: tt.train_lightglue_on_frontend(
            ClassicalFrontend(), steps=1),
        "superpoint_init": lambda: tsp.init_params(gen),
        "lightglue_init": lambda: tlg.init_params(gen),
        "main": lambda: tt.main(["--which", "lightglue-toy", "--steps", "1"]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_max_pool_gradient_at_ties():
    """SuperPoint's 2x2 pool: JAX's reshape-max splits a window's gradient
    among tied maxima, F.max_pool2d gives it to one. Both agree on every
    window without a tie, on each window's total, and where the tie is
    at 0 after the ReLU (no gradient passes there)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 3)).astype(np.float32)
    x[0:2, 0:2, 0] = 0.7  # a positive tie
    x[2:4, 0:2, 1] = -0.3  # a tie at 0 after the ReLU
    w = rng.normal(size=(4, 4, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(w * jsp._pool2(jax.nn.relu(a))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    pooled = torch.nn.functional.max_pool2d(torch.relu(xt).permute(2, 0, 1)[None], 2)
    (pooled[0].permute(1, 2, 0) * torch.from_numpy(w)).sum().backward()
    got = xt.grad.numpy()
    win = lambda a: a.reshape(4, 2, 4, 2, 3).sum(axis=(1, 3))  # noqa: E731
    np.testing.assert_allclose(win(got), win(want), rtol=1e-6)
    tied = np.zeros((8, 8, 3), bool)
    tied[0:2, 0:2, 0] = True
    np.testing.assert_array_equal(got[~tied], want[~tied])
    np.testing.assert_allclose(want[0:2, 0:2, 0], w[0, 0, 0] / 4, rtol=1e-6)
    assert np.count_nonzero(got[0:2, 0:2, 0]) == 1
    assert not np.any(got[2:4, 0:2, 1]) and not np.any(want[2:4, 0:2, 1])
