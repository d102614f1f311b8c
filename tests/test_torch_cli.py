"""The port's host layer against the JAX package's: checkpoints, figures
and dumps, the command line, and the sequence YAML and video path.

- Checkpoints: a state saved by either package loads in the other with
  equal leaves (bf16 exactly: its values are bf16-representable float32 in
  the file), the port's own round trip is bit-identical in its dtypes, and
  a v1 (positional) file migrates as tests/test_utils.py's does.
- The command line, in process on the CPU, on tests/test_utils.py's
  arguments: the JAX CLI's artifacts, and the printed ATE within the JAX
  CLI's band on the same arguments: at most 1.5x its reading plus 1e-3
  units (the two bootstraps draw their RANSAC samples from different
  generators, so the runs are a band, not a match; on these arguments both
  read 0.0043). Without a card and without --device cpu it raises.
- The YAML and encoded-video path (cv2): tests/test_video_e2e.py's checks
  at its thresholds, on the port, plus the port's decoded frames equal to
  the JAX package's and the native decoder's equal to cv2's.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_slam_tpu.utils import checkpoint as jckpt
from racing_slam_tpu_torch import native_bindings
from racing_slam_tpu_torch.ops.camera import Camera
from racing_slam_tpu_torch.slam.config import SlamConfig, load_sequence_yaml
from racing_slam_tpu_torch.slam.pipeline import Slam
from racing_slam_tpu_torch.slam.state import SlamState
from racing_slam_tpu_torch.utils import checkpoint as tckpt
from racing_slam_tpu_torch.utils import viz
from racing_slam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from racing_slam_tpu_torch.utils.metrics import ate_rmse, camera_centers
from racing_slam_tpu_torch.utils.synthetic import make_sequence
from racing_slam_tpu_torch.utils.video import VideoLoader, load_mask, open_video
from tests.test_torch_state import _random_state

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _jax_state(rng):
    """tests/test_torch_state.py's random state, with every field that a
    default leaves at zero filled: bf16 descriptors, archive, counters."""
    st = _random_state(rng)
    P, O, D = st.obs_desc.shape
    A = st.arch_frame_index.shape[0]
    return st._replace(
        obs_desc=jnp.asarray(rng.normal(size=(P, O, D)), jnp.bfloat16),
        arch_rvec=jnp.asarray(rng.normal(size=(A, 3)), jnp.float32),
        arch_count=jnp.int32(3), arch_frame_index=jnp.arange(A, dtype=jnp.int32),
        last_inliers=jnp.int32(57), frame_count=jnp.int32(11),
        last_rvec=jnp.asarray([0.1, 0.2, 0.3], jnp.float32),
    )


def _assert_leaves_equal(got, want):
    """Two states as numpy trees (JAX dtypes), leaf by leaf, exactly."""
    g = jax.tree.leaves(state_to_numpy(got) if isinstance(got, SlamState) else got)
    w = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32)
                                     if x.dtype == jnp.bfloat16 else np.asarray(x), want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def test_checkpoint_port_round_trip_is_bit_identical(tmp_path, rng):
    st = state_from_numpy(jax.tree.map(np.asarray, _jax_state(rng)), device="cpu")
    tckpt.save_state(tmp_path / "s.npz", st)
    back = tckpt.load_state(tmp_path / "s.npz", device="cpu")
    for name, a in tckpt._named_leaves(st).items():
        b = tckpt._named_leaves(back)[name]
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_checkpoint_jax_to_port(tmp_path, rng):
    st = _jax_state(rng)
    jckpt.save_state(tmp_path / "j.npz", st)
    _assert_leaves_equal(tckpt.load_state(tmp_path / "j.npz", device="cpu"), st)


def test_checkpoint_port_to_jax(tmp_path, rng):
    st = state_from_numpy(jax.tree.map(np.asarray, _jax_state(rng)), device="cpu")
    tckpt.save_state(tmp_path / "t.npz", st)
    back = jckpt.load_state(tmp_path / "t.npz")
    assert back.obs_desc.dtype == jnp.bfloat16
    _assert_leaves_equal(st, back)
    assert list(tckpt._named_leaves(st)) == list(jckpt._named_leaves(back))


def test_checkpoint_v1_migration(tmp_path, rng):
    """A v1 file (positional leaf_N, the state before the archive fields,
    written as the v1 save_state did) loads: the shared fields exactly, the
    appended ones backfilled at the requested archive capacity."""
    st = _jax_state(rng)
    v1 = [(n, x) for n, x in jckpt._named_leaves(st).items() if n not in jckpt._V1_ABSENT]
    out = {}
    for i, (_, x) in enumerate(v1):
        a = np.asarray(x)
        out[f"leaf_{i}__bf16" if a.dtype.name == "bfloat16" else f"leaf_{i}"] = \
            a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    np.savez_compressed(tmp_path / "v1.npz", **out)
    got = tckpt.load_state(tmp_path / "v1.npz", archive_capacity=7, device="cpu")
    assert tckpt._V1_ABSENT == jckpt._V1_ABSENT
    named = tckpt._named_leaves(got)
    for n, x in v1:
        a = np.asarray(x)
        want = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(named[n].float().numpy() if named[n].dtype ==
                                      torch.bfloat16 else named[n].numpy(), want)
    assert got.arch_frame_index.shape == (7,) and int(got.arch_count) == 0
    assert int(got.last_inliers) == 0 and int(got.num_kf) == int(st.num_kf)


def test_checkpoint_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    st = SlamState.create(F=2, P=4, O=2, K=3, D=2, A=2, device="cpu")
    tckpt.save_state(tmp_path / "s.npz", st)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_state(tmp_path / "s.npz")


def test_viz_outputs(tmp_path, rng):
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5) * 0.1
    pts = rng.standard_normal((30, 3)).astype(np.float32)
    viz.save_trajectory_plot(tmp_path / "t.png", poses, pts)
    viz.export_ply(tmp_path / "m.ply", pts, poses=poses)
    viz.save_trajectory_tum(tmp_path / "t.tum", poses)
    assert (tmp_path / "t.png").stat().st_size > 1000
    ply = (tmp_path / "m.ply").read_text()
    assert ply.startswith("ply") and f"element vertex {30 + 5}" in ply
    assert len((tmp_path / "t.tum").read_text().splitlines()) == 5
    from racing_slam_tpu.utils import viz as jviz

    jviz.export_ply(tmp_path / "j.ply", pts, poses=poses)
    jviz.save_trajectory_tum(tmp_path / "j.tum", poses)
    assert (tmp_path / "j.ply").read_text() == ply
    assert (tmp_path / "j.tum").read_text() == (tmp_path / "t.tum").read_text()
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    kp = rng.uniform(0, 48, (20, 2))
    viz.save_overlay(tmp_path / "o.png", img, kp, kp + 1.0, np.arange(20) % 2 == 0)
    assert (tmp_path / "o.png").stat().st_size > 1000


def test_timing_and_metrics_sink(tmp_path, capsys):
    """The stage timer and time_it on CPU tensors (no device wait), the
    JSONL sink on tensor, numpy and python values, and a profiler trace."""
    import json

    from racing_slam_tpu_torch.utils.timing import MetricsSink, StageTimer, profiler_trace, time_it

    t = StageTimer()
    for _ in range(3):
        with t.stage("step", block_on=(torch.ones(2), [torch.zeros(1)])):
            pass
    assert t.summary()["step"]["count"] == 3 and "step" in t.report()
    assert torch.equal(time_it("add", lambda: torch.ones(3) + 1), torch.full((3,), 2.0))
    assert capsys.readouterr().out.startswith("add: ")
    sink = MetricsSink(tmp_path / "m.jsonl")
    sink.write(dict(a=torch.tensor(3), b=np.float32(0.5), c=np.arange(2), d=True, e=torch.ones(2)))
    sink.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == dict(a=3, b=0.5, c=[0, 1], d=True,
                                                                  e=[1.0, 1.0])
    with profiler_trace(tmp_path / "trace"):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


CLI_ARGS = ["--synthetic", "--synthetic-frames", "10", "--max-frames", "6", "--quiet",
            "--max-keyframes", "8", "--map-capacity", "1024"]


def _ate_printed(text: str) -> float:
    return float(re.search(r"ATE vs ground truth: ([0-9.]+)", text).group(1))


def test_cli_synthetic(tmp_path, capsys):
    from racing_slam_tpu.run import main as jax_main
    from racing_slam_tpu_torch.run import main

    out = tmp_path / "out"
    assert main([*CLI_ARGS, "--out", str(out), "--device", "cpu", "--overlay-every", "3"]) == 0
    got = capsys.readouterr().out
    for f in ["trajectory.png", "map.ply", "trajectory.tum", "state.npz", "metrics.jsonl",
              "overlay_00003.png", "overlay_00006.png"]:
        assert (out / f).exists(), f
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 6
    assert jax_main([*CLI_ARGS, "--out", str(tmp_path / "jax")]) == 0
    want = _ate_printed(capsys.readouterr().out)
    assert _ate_printed(got) <= 1.5 * want + 1e-3, (got, want)

    # Resume from the checkpoint: no bootstrap, the saved keyframe count.
    num_kf = int(np.load(out / "state.npz")["num_kf"])
    resume = [*CLI_ARGS, "--max-frames", "2", "--device", "cpu", "--resume", str(out / "state.npz")]
    assert main(resume) == 0
    got = capsys.readouterr().out
    assert f"resumed from {out / 'state.npz'} (kf={num_kf})" in got
    assert "Initialized" not in got and "processed 2 frames" in got
    with pytest.raises(ValueError, match="capacities"):
        main([*resume, "--map-capacity", "2048"])


def test_cli_without_a_card_raises(tmp_path):
    from racing_slam_tpu_torch.run import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([*CLI_ARGS, "--synthetic-frames", "2", "--out", str(tmp_path)])


def test_cli_learned_needs_weights(tmp_path, capsys):
    from racing_slam_tpu_torch.run import main

    rc = main([*CLI_ARGS, "--synthetic-frames", "2", "--device", "cpu", "--frontend", "learned",
               "--weights", str(tmp_path / "absent.npz")])
    assert rc == 2 and "needs trained weights" in capsys.readouterr().err


def test_cli_learned_without_a_weights_file_runs_on_random_weights(tmp_path, monkeypatch, capsys):
    """As the JAX command line: no --weights and no committed file -> random
    SuperPoint weights (init_params), with a note."""
    from racing_slam_tpu_torch import models
    from racing_slam_tpu_torch.run import main

    monkeypatch.setattr(models, "WEIGHTS_DIR", tmp_path)
    rc = main([*CLI_ARGS, "--synthetic-frames", "4", "--max-frames", "2", "--device", "cpu",
               "--frontend", "learned"])
    out = capsys.readouterr().out
    assert "note: --frontend learned with RANDOM weights" in out
    assert rc == 0, out[-2000:]


# ---------------------------------------------------------------------------
# The sequence YAML and encoded video (tests/test_video_e2e.py on the port)
# ---------------------------------------------------------------------------

W, H = 320, 240
MASK_ROWS = 24  # bottom rows masked out


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A synthetic sequence encoded to mp4, a mask PNG and a sequence YAML."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("video")
    cam = Camera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=W, height=H)
    seq = make_sequence(np.random.default_rng(11), n_frames=18, cam=cam, n_sprites=140,
                        step_t=np.array([0.10, 0.01, 0.16], np.float32))
    video = root / "seq.mp4"
    wr = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (W, H))
    assert wr.isOpened(), "cv2 VideoWriter failed to open (no mp4v codec?)"
    for f in seq.frames:
        wr.write(cv2.cvtColor(np.clip(f * 255.0, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR))
    wr.release()
    mask = np.full((H, W), 255, np.uint8)
    mask[H - MASK_ROWS:] = 0
    cv2.imwrite(str(root / "mask.png"), mask)
    yaml_path = root / "seq.yaml"
    yaml_path.write_text("video: seq.mp4\nmask: mask.png\nfx: 240.0\nfy: 240.0\n")
    return dict(root=root, yaml=yaml_path, video=video, mask=root / "mask.png", seq=seq, cam=cam)


def test_sequence_yaml_loading(assets):
    from racing_slam_tpu.slam.config import load_sequence_yaml as jax_load

    sc = load_sequence_yaml(assets["yaml"])
    assert sc.video.endswith("seq.mp4") and sc.mask.endswith("mask.png")
    assert sc.fx == 240.0 and sc.fy == 240.0
    assert sc.cx is None and sc.cy is None  # the image centre
    assert vars(sc) == vars(jax_load(assets["yaml"]))


def test_encoded_video_roundtrip(assets):
    from racing_slam_tpu.utils.video import VideoLoader as JaxVideoLoader

    frames = VideoLoader(str(assets["video"])).get_all_frames()
    assert len(frames) == 18 and frames[0].shape == (H, W)
    src = np.asarray(assets["seq"].frames[0], np.float32)
    assert np.abs(frames[0] - src).mean() < 0.02  # codec noise only
    want = JaxVideoLoader(str(assets["video"])).get_all_frames()
    for a, b in zip(frames, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_native_video_loader(assets):
    """open_video takes the native threaded decoder when its library loads
    (it is built by `make -C native`, not tracked by git) and gives cv2's
    grayscale frames as uint8; otherwise it says it fell back to cv2."""
    import cv2

    cap = cv2.VideoCapture(str(assets["video"]))
    want = []
    while (f := cap.read())[0]:
        want.append(cv2.cvtColor(f[1], cv2.COLOR_BGR2GRAY))
    assert len(want) == 18
    fallback = open_video(str(assets["video"]), prefer_native=False)
    assert fallback.decoder == "cv2"
    for g, w in zip(fallback, want, strict=True):
        np.testing.assert_array_equal(g, w.astype(np.float32) / 255.0)
    vl = open_video(str(assets["video"]))
    if not native_bindings.available():
        assert vl.decoder == "cv2"
        return
    assert vl.decoder == "native" and (vl.width, vl.height) == (W, H)
    got = list(vl)
    vl.close()
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(load_mask(str(assets["mask"])),
                                  native_bindings.load_mask_native(str(assets["mask"])))


def test_encoded_video_masked_slam_ate(assets):
    """The engine on decoded frames with the static mask: tracking holds at
    tests/test_video_e2e.py's bound, and no keyframe keypoint lies in the
    masked band."""
    seq = assets["seq"]
    cfg = SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                     cull_points=True, max_keyframes=16, map_capacity=2048)
    mask = load_mask(str(assets["mask"]))
    assert mask.shape == (H, W) and mask[-1].max() == 0.0
    slam = Slam(assets["cam"], open_video(str(assets["video"])), cfg, static_mask=mask,
                device="cpu")
    assert slam.initialize()
    slam.run()
    kf_idx = slam.keyframe_indices()
    assert len(kf_idx) >= 4
    gt = seq.poses[kf_idx]
    ate = ate_rmse(slam.poses(), gt)
    length = np.linalg.norm(camera_centers(gt)[-1] - camera_centers(gt)[0])
    assert ate < 0.08 * length, f"ATE {ate} vs trajectory length {length}"
    kfs = slam.state.kfs
    ys = kfs.kp_xy[..., 1][kfs.kp_valid].numpy()
    assert (ys < H - MASK_ROWS + 1).all()


def test_cli_on_encoded_sequence(assets, tmp_path):
    """python -m racing_slam_tpu_torch <yaml> --device cpu writes the
    artifact set and prints the decoder it chose."""
    out = tmp_path / "artifacts"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "racing_slam_tpu_torch", str(assets["yaml"]), "--out", str(out),
         "--quiet", "--max-keyframes", "16", "--map-capacity", "2048", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for name in ["trajectory.png", "map.ply", "trajectory.tum", "state.npz", "metrics.jsonl"]:
        assert (out / name).exists(), f"missing artifact {name}"
    assert "reprojection error" in proc.stdout
    # Which one depends on whether the native library loads in that process.
    assert re.search(r"^decoder: (native|cv2)$", proc.stdout, re.M), proc.stdout[:500]
