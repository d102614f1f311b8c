"""The essential decomposition's cheirality choice, the port's against the
JAX package's, on the pairs `tools/pose_probe.py --dump-flips FILE` saved
from the card (the pairs whose rotation came out more than 90 degrees
off there). Runs on the CPU:

    env JAX_PLATFORMS=cpu python tests/decompose_probe.py FILE

For each pair, the port's RANSAC on the CPU from the saved matches and
uniforms (float64 algebra, as on the card) gives E and its inliers. Then
both packages decompose that E and count, for each of the four (R, t)
candidates, the inliers that triangulate in front of both cameras: the
port's ops.essential.decompose + ops.triangulation, and the JAX
package's (float32 under its f32_precision). Printed per pair: both
packages' counts and chosen candidate, the rotation error of each choice
against the ground truth, and the JAX package's own RANSAC on the same
matches with its PRNG key (another sample, for the spread).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from racing_slam_tpu.ops import essential as jess  # noqa: E402
from racing_slam_tpu.ops import ransac as jrans  # noqa: E402
from racing_slam_tpu.ops import triangulation as jtri  # noqa: E402
from racing_slam_tpu.ops.camera import Camera as JaxCamera  # noqa: E402
from racing_slam_tpu_torch.ops import essential as tess  # noqa: E402
from racing_slam_tpu_torch.ops import ransac as trans  # noqa: E402
from racing_slam_tpu_torch.ops import triangulation as ttri  # noqa: E402
from racing_slam_tpu_torch.ops.camera import Camera  # noqa: E402


def _r_deg(R: np.ndarray, T: np.ndarray) -> float:
    c = (np.trace(R.T @ T[:3, :3]) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(path: str) -> int:
    jax.config.update("jax_platforms", "cpu")
    z = np.load(path)
    cam_f = z["cam"]
    cam = Camera(*[float(v) for v in cam_f[:4]], int(cam_f[4]), int(cam_f[5]))
    jcam = JaxCamera(*cam)
    for n, frame in enumerate(z["frame"]):
        uv1, uv2, mask, uni, T = (z[f"{k}_{n}"] for k in ("uv1", "uv2", "mask", "uniforms", "T"))
        est = trans.estimate_relative_pose(cam, torch.from_numpy(uv1), torch.from_numpy(uv2),
                                           torch.from_numpy(mask), uniforms=torch.from_numpy(uni))
        E, inl = est.essential, est.inliers
        Rs, ts = tess.decompose(E)
        eye = torch.eye(4)
        rels = eye.expand(4, 4, 4).clone()
        rels[:, :3, :3], rels[:, :3, 3] = Rs, ts
        port = ttri.triangulate_points(cam, eye, rels, torch.from_numpy(uv1)[None],
                                       torch.from_numpy(uv2)[None], mask=inl[None])
        port_counts = port.valid.sum(-1).tolist()
        jRs, jts = jess.decompose(jnp.asarray(E.numpy()))
        jcounts = []
        for i in range(4):
            rel = jnp.eye(4).at[:3, :3].set(jRs[i]).at[:3, 3].set(jts[i])
            tri = jtri.triangulate_points(jcam, jnp.eye(4), rel, jnp.asarray(uv1), jnp.asarray(uv2),
                                          mask=jnp.asarray(inl.numpy()))
            jcounts.append(int(jnp.sum(tri.valid)))
        pi, ji = int(np.argmax(port_counts)), int(np.argmax(jcounts))
        jest = jrans.estimate_relative_pose(jcam, jnp.asarray(uv1), jnp.asarray(uv2),
                                            jnp.asarray(mask), jax.random.PRNGKey(int(frame)))
        print("decompose_probe " + json.dumps(dict(
            frame=int(frame), inliers=int(inl.sum()),
            port_counts=port_counts, port_choice=pi,
            port_R_deg=_r_deg(Rs[pi].numpy(), T), port_ransac_R_deg=_r_deg(
                est.pose[:3, :3].numpy(), T),
            jax_counts=jcounts, jax_choice=ji, jax_R_deg=_r_deg(np.asarray(jRs[ji]), T),
            jax_own_ransac_R_deg=_r_deg(np.asarray(jest.pose)[:3, :3], T))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
