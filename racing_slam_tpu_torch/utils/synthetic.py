"""Synthetic scenes and video sequences with exact ground-truth geometry
(port of racing_slam_tpu/utils/synthetic.py; the same numpy code, so the
same seed renders the same frames).

- 2D: multi-octave noise textures (frontend tests).
- 3D: a "sprite world": textured fronto-parallel quads, each on its own
  world plane z = const, so every rendered pixel comes from an exact 3D
  point under an exact plane homography.

All host-side NumPy. The camera is duck-typed: anything with fx, fy, cx,
cy, width and height (the port's Camera or the JAX package's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.camera import Camera


def random_texture(h: int, w: int, rng: np.random.Generator, octaves: int = 4) -> np.ndarray:
    """Multi-octave smoothed noise in [0, 1]; corner-rich at all scales."""
    from scipy.ndimage import zoom

    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2**o
        small = rng.standard_normal((max(2, h // (4 * s)), max(2, w // (4 * s))))
        up = zoom(small, (h / small.shape[0], w / small.shape[1]), order=3)
        img += up[:h, :w].astype(np.float32) / (o + 1)
    img -= img.min()
    img /= img.max() + 1e-9
    return img


@dataclass
class SpriteWorld:
    """Textured quads on per-sprite planes z = depth (world frame)."""

    centers: np.ndarray  # [S, 3] world centers
    half_sizes: np.ndarray  # [S] half extent in world units
    textures: list  # S textures [T, T] float32

    @staticmethod
    def generate(
        rng: np.random.Generator,
        n_sprites: int = 120,
        depth_range: tuple = (5.0, 14.0),
        lateral: float = 6.0,
        half_size_range: tuple = (0.25, 0.6),
        tex_size: int = 48,
    ) -> "SpriteWorld":
        depths = rng.uniform(*depth_range, n_sprites)
        centers = np.stack(
            [
                rng.uniform(-lateral, lateral, n_sprites) * (depths / depth_range[0]) * 0.6,
                rng.uniform(-lateral * 0.7, lateral * 0.7, n_sprites)
                * (depths / depth_range[0])
                * 0.6,
                depths,
            ],
            axis=-1,
        ).astype(np.float32)
        half_sizes = rng.uniform(*half_size_range, n_sprites).astype(np.float32)
        textures = [random_texture(tex_size, tex_size, rng) for _ in range(n_sprites)]
        return SpriteWorld(centers=centers, half_sizes=half_sizes, textures=textures)

    def render(self, cam: Camera, pose: np.ndarray, background: float = 0.08,
               near_clip: float = 0.1) -> np.ndarray:
        """Render the world under a world->camera pose. Exact plane-homography
        sampling: each drawn pixel's intensity comes from a known 3D point.
        Returns [H, W] float32 in [0, 1].

        near_clip: sprites with any corner closer than this are not drawn.
        Long dolly sequences raise it (~3.0): a sprite passing the camera at
        depth < ~3 is magnified into a screen-filling defocus-like blur that
        blanks feature detection for several frames — an artifact real
        footage does not have (lenses defocus/occlusion-cull at near range).
        """
        H, W = cam.height, cam.width
        img = np.full((H, W), background, np.float32)
        R = pose[:3, :3]
        t = pose[:3, 3]
        c = -R.T @ t  # camera center in world
        Kinv = np.linalg.inv(
            np.array(
                [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32
            )
        )
        # Far-to-near painter's order (distinct planes never interleave).
        order = np.argsort(-self.centers[:, 2])
        for si in order:
            ctr = self.centers[si]
            hs = self.half_sizes[si]
            tex = self.textures[si]
            T = tex.shape[0]
            # Project the quad corners to bound the raster region.
            corners = ctr + np.array(
                [[-hs, -hs, 0], [hs, -hs, 0], [hs, hs, 0], [-hs, hs, 0]], np.float32
            )
            pc = (R @ corners.T).T + t
            if np.any(pc[:, 2] <= near_clip):
                continue
            uv = pc[:, :2] * np.array([cam.fx, cam.fy]) / pc[:, 2:3] + np.array(
                [cam.cx, cam.cy]
            )
            u0 = max(int(np.floor(uv[:, 0].min())), 0)
            u1 = min(int(np.ceil(uv[:, 0].max())) + 1, W)
            v0 = max(int(np.floor(uv[:, 1].min())), 0)
            v1 = min(int(np.ceil(uv[:, 1].max())) + 1, H)
            if u0 >= u1 or v0 >= v1:
                continue
            us, vs = np.meshgrid(np.arange(u0, u1), np.arange(v0, v1))
            rays = np.stack(
                [us.ravel(), vs.ravel(), np.ones(us.size)], axis=-1
            ).astype(np.float32) @ Kinv.T  # camera-space directions
            dirs_w = rays @ R  # = R^T @ ray, world-space directions
            denom = dirs_w[:, 2]
            ok = np.abs(denom) > 1e-9
            lam = np.where(ok, (ctr[2] - c[2]) / np.where(ok, denom, 1.0), -1.0)
            Xw = c[None, :] + lam[:, None] * dirs_w
            lx = (Xw[:, 0] - ctr[0]) / hs  # [-1, 1] inside the quad
            ly = (Xw[:, 1] - ctr[1]) / hs
            inside = ok & (lam > 0) & (np.abs(lx) <= 1.0) & (np.abs(ly) <= 1.0)
            tx = np.clip((lx + 1.0) * 0.5 * (T - 1), 0, T - 1.001)
            ty = np.clip((ly + 1.0) * 0.5 * (T - 1), 0, T - 1.001)
            x0 = tx.astype(np.int32)
            y0 = ty.astype(np.int32)
            fx = tx - x0
            fy = ty - y0
            val = (
                tex[y0, x0] * (1 - fx) * (1 - fy)
                + tex[y0, np.minimum(x0 + 1, T - 1)] * fx * (1 - fy)
                + tex[np.minimum(y0 + 1, T - 1), x0] * (1 - fx) * fy
                + tex[np.minimum(y0 + 1, T - 1), np.minimum(x0 + 1, T - 1)] * fx * fy
            )
            patch = img[v0:v1, u0:u1].ravel()
            patch[inside] = val[inside]
            img[v0:v1, u0:u1] = patch.reshape(v1 - v0, u1 - u0)
        return img


@dataclass
class SyntheticSequence:
    frames: list  # [H, W] float32 images
    poses: np.ndarray  # [N, 4, 4] ground-truth world->camera
    cam: Camera
    world: SpriteWorld


def make_sequence(
    rng: np.random.Generator,
    n_frames: int = 20,
    cam: Camera | None = None,
    step_t: np.ndarray | None = None,
    yaw_per_frame: float = 0.004,
    n_sprites: int = 120,
) -> SyntheticSequence:
    """Forward+lateral dolly through a sprite world (racing-like motion)."""
    from scipy.spatial.transform import Rotation

    if cam is None:
        cam = Camera(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480)
    if step_t is None:
        step_t = np.array([0.12, 0.01, 0.22], np.float32)  # lateral + forward

    # For trajectories with real forward motion, populate sprites along the
    # path at constant IN-VIEW density: each sprite sits mid-view (depth
    # ~U[5,14], the same band SpriteWorld.generate uses) of the camera's
    # TRUE pose — including accumulated yaw — at a uniformly drawn anchor
    # frame i*. The earlier straight-corridor placement ignored yaw: by
    # frame ~300 at 0.002 rad/frame the camera had rotated ~34 degrees off
    # the corridor and the scene emptied, starving tracking (and even the
    # two-view bootstrap) for reasons unrelated to the engine.
    step_z = float(step_t[2])
    total_forward = step_z * max(n_frames - 1, 0)
    if total_forward > 1.0:
        # Anchor frames extend past both sequence ends: a sprite anchored at
        # i* (mid-view depth ~9.5) is visible from ~(25-9.5)/step_z frames
        # BEFORE i* until ~(9.5-2)/step_z after, so without the overhang the
        # first/last stretches see a fraction of the density.
        lo = -(9.5 - 2.0) / step_z
        hi = (n_frames - 1) + (25.0 - 9.5) / step_z
        n_eff = max(n_sprites, int(n_sprites * step_z * (hi - lo) / 9.0))
        i_star = rng.uniform(lo, hi, n_eff)
        d = rng.uniform(5.0, 14.0, n_eff)
        lat = 6.0 * 0.6 * (9.5 / 5.0)
        u = rng.uniform(-lat, lat, n_eff)
        v = rng.uniform(-lat * 0.7, lat * 0.7, n_eff)
        # Clearance corridor: a sprite whose view-space offset is near zero
        # sits ON the camera path — as the dolly reaches it, it fills (and
        # passes through) the view, blanking the frame for several frames
        # (measured: 60-frame tracking dropouts). Real cameras do not drive
        # through obstacles; push such sprites out to stream past the lens
        # like roadside objects. Distant sprites still cover the image
        # center (angle ~ u/depth), so central texture is unaffected.
        inside = (np.abs(u) < 1.2) & (np.abs(v) < 0.8)
        u = np.where(inside, np.sign(u + 1e-9) * (1.2 + np.abs(u)), u)
        yaw = yaw_per_frame * i_star
        cw = np.asarray(step_t)[None, :] * i_star[:, None]
        # center = cam_center(i*) + Ry(yaw(i*)) @ [u, v, d]
        sin, cos = np.sin(yaw), np.cos(yaw)
        cx = cw[:, 0] + cos * u + sin * d
        cy = cw[:, 1] + v
        cz = cw[:, 2] - sin * u + cos * d
        # 128 px textures (finest noise octave 32x32): a 48 px texture
        # magnified onto a CLOSE sprite (depth ~2-3 covers 200-300 px on
        # screen) becomes a featureless blur — measured to crash the corner
        # detector to ~90 valid keypoints on frames dominated by close
        # sprites, starving tracking for content reasons no real video has
        # (real footage keeps detail at every scale).
        world = SpriteWorld(
            centers=np.stack([cx, cy, cz], axis=-1).astype(np.float32),
            half_sizes=rng.uniform(0.25, 0.6, n_eff).astype(np.float32),
            textures=[random_texture(128, 128, rng) for _ in range(n_eff)],
        )
    else:
        world = SpriteWorld.generate(rng, n_sprites=n_sprites)
    poses = []
    frames = []
    for i in range(n_frames):
        T = np.eye(4, dtype=np.float32)
        Rw = Rotation.from_rotvec([0.0, yaw_per_frame * i, 0.0]).as_matrix()
        cw = step_t * i  # camera center in world
        T[:3, :3] = Rw.T
        T[:3, 3] = -Rw.T @ cw
        poses.append(T)
        frames.append(
            world.render(cam, T, near_clip=3.0 if total_forward > 1.0 else 0.1)
        )
    return SyntheticSequence(
        frames=frames, poses=np.stack(poses), cam=cam, world=world
    )
