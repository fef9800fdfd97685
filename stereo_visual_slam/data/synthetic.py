"""Synthetic stereo sequence generator with exact ground truth.

No KITTI dataset ships in this environment, so correctness and benchmarks run
on synthetic sequences rendered to the same geometry as KITTI odometry
(1241x376, fx=718.856, baseline 0.573 m).

World model — "billboard sprites": a field of 3D points, each carrying a
fixed random texture patch. A frame is rendered by projecting every visible
point into the left/right cameras and alpha-pasting its patch at the
projection with bilinear sub-pixel placement over a low-frequency background.
Properties that make this a faithful testbed:

  * every landmark has a distinctive local appearance -> ORB descriptors are
    matchable frame-to-frame exactly like real corners;
  * the left/right views of a patch differ by the true disparity of its
    center -> stereo ZNCC recovers metric depth;
  * ground-truth camera poses are known exactly -> trajectory error is
    measurable to machine precision.

Rendering is plain numpy on the host (it stands in for the dataset reader,
which in the reference is disk IO, visual_odometry.cpp:37-68).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from stereo_visual_slam.utils.config import Config


@dataclasses.dataclass
class SyntheticWorld:
    points: np.ndarray          # (M, 3) world coords
    patches: np.ndarray         # (M, P, P) float32 textures
    poses_T_c_w: np.ndarray     # (F, 4, 4) ground-truth world->camera
    config: Config
    profile: str = "default"
    # physical sprite sizes in metres: rendered pixel size = fx*size/z, so
    # appearance SCALES with depth like real surfaces (None = fixed-pixel
    # billboards, the default profile's scale-free world)
    sizes: np.ndarray | None = None
    # "hard" profile extras: independently moving occluder sprites
    # (positions per frame) and photometric drift parameters
    occ_pos: np.ndarray | None = None      # (F, O, 3) world coords per frame
    occ_patches: np.ndarray | None = None  # (O, Q, Q) textures
    occ_sizes: np.ndarray | None = None    # (O,) metres
    noise_sigma: float = 0.0
    gain_amp: float = 0.0
    bias_amp: float = 0.0


def _se3_from_yaw_pos(yaw: float, pos: np.ndarray) -> np.ndarray:
    """T_w_c for a camera at `pos` yawed by `yaw` about world Y (camera
    convention: x right, y down, z forward)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R_w_c = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    T = np.eye(4)
    T[:3, :3] = R_w_c
    T[:3, 3] = pos
    return T


def make_world(
    config: Config,
    n_frames: int = 100,
    n_points: int = 4000,
    patch: int = 13,
    speed: float | None = None,
    yaw_rate: float | None = None,
    seed: int = 0,
    profile: str = "default",
    scaled_sprites: bool | None = None,
) -> SyntheticWorld:
    """Build a world and a smooth forward trajectory with gentle turning.

    speed: metres per frame (KITTI @ 10 Hz ~ 1 m/frame at 36 km/h).
    yaw_rate: radians per frame of sinusoidal steering.

    profile="hard" stresses the tracker toward KITTI seq-00 difficulty
    (the reference's headline run, README.md:92-97): per-frame sensor noise
    + exposure/gain drift + L/R gain mismatch, independently MOVING
    near-field occluder sprites (violating rigid-world PnP), a low-texture
    stretch (most landmarks vanish for ~12 % of the path), and one sharp
    ~80 degree turn at reduced speed.

    profile="highway" is the KITTI seq-01 analog (the reference's other
    robustness claim, README.md:97): ~2.7 m/frame forward speed (KITTI 01
    averages ~2.5-2.8 m/frame at 10 Hz), SPARSE roadside structure (about
    half the per-metre feature density of the default corridor, mostly
    ground-plane texture with thin barrier lines), perspective sprite
    scaling (fast approach = fast appearance growth), gentle lane-change
    curvature only, and mild sensor noise. Stresses large-baseline
    matching, per-frame disparity change, and the keyframe rule under fast
    forward motion.
    """
    hard = profile == "hard"
    highway = profile == "highway"
    # per-profile defaults resolve ONLY when the caller did not pass a value
    # (None sentinel): an explicit speed=1.0 with profile="highway" sticks
    if speed is None:
        speed = 2.7 if highway else 1.0
    if yaw_rate is None:
        yaw_rate = 0.0015 if highway else 0.004
    if scaled_sprites is None:
        # perspective scale change is part of "hard" and "highway"
        scaled_sprites = hard or highway
    rng = np.random.default_rng(seed)

    # Trajectory: integrate heading. The hard profile injects a sharp-turn
    # segment mid-sequence (0.04 rad/frame for ~1/9 of the frames) at half
    # speed, like an urban 90-degree corner.
    turn_lo, turn_hi = int(n_frames * 0.55), int(n_frames * 0.55) + max(
        n_frames // 9, 8
    )
    poses_T_w_c = []
    pos = np.zeros(3)
    yaw = 0.0
    for f in range(n_frames):
        poses_T_w_c.append(_se3_from_yaw_pos(yaw, pos.copy()))
        dyaw = yaw_rate * np.sin(2 * np.pi * f / max(n_frames, 1) * 2.0)
        v = speed
        if hard and turn_lo <= f < turn_hi:
            dyaw += 0.04
            v = speed * 0.5
        yaw += dyaw
        heading = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + v * heading
    poses_T_w_c = np.stack(poses_T_w_c)
    path_len = speed * n_frames

    # Points on SURFACES of a corridor around the path (camera y is DOWN,
    # mounted 1.65 m above ground like the KITTI rig): a ground plane and two
    # walls. Surface structure matters: neighboring points share depth, so
    # stereo windows straddling sprite boundaries stay depth-consistent, as
    # in real scenes. The sky is left dark and featureless.
    # Path-frame corridor, ALL profiles: each point picks a station t along
    # the (extended) path and a lateral offset in the local ground frame —
    # valid for arbitrarily bent trajectories. (The previous default/highway
    # construction built a straight tube and bent it by interpolating the
    # path's x as a function of ABSOLUTE z; once a long trajectory's yaw
    # passes ~90 degrees, z folds back, the interpolation mixes the
    # outbound and return passes, and the corridor scatters away from the
    # road — the round-4 soak failed exactly this way: ~99% of "near"
    # points landed >20 m off-path and tracking ran on far-field clutter.)
    #
    # Profile geometry: highway = wider road, LOW guardrails (<= 1.3 m),
    # mostly ground texture, structure spread further ahead; default/hard =
    # 5.5 m walls at +-12 m.
    n_ground = int(n_points * 0.65) if highway else n_points // 2
    z_reach = 160.0 if highway else 80.0
    road_half = 16.0 if highway else 14.0
    wall_x = 14.0 if highway else 12.0
    wall_top = 0.35 if highway else -4.0
    ext = z_reach / speed  # structure past the end so the tail sees texture
    t = rng.uniform(0.0, n_frames - 1 + ext, n_points)
    yaws = np.unwrap(
        np.arctan2(poses_T_w_c[:, 0, 2], poses_T_w_c[:, 2, 2])
    )
    f_idx = np.arange(n_frames, dtype=np.float64)
    px = np.interp(t, f_idx, poses_T_w_c[:, 0, 3])
    pz = np.interp(t, f_idx, poses_T_w_c[:, 2, 3])
    pyaw = np.interp(t, f_idx, yaws)
    # extrapolate past the last frame along the final heading
    over = np.maximum(t - (n_frames - 1), 0.0) * speed
    px = px + over * np.sin(yaws[-1])
    pz = pz + over * np.cos(yaws[-1])
    perp = np.stack([np.cos(pyaw), -np.sin(pyaw)], axis=-1)  # (N, 2) x,z
    lat = np.empty(n_points)
    y = np.empty(n_points)
    lat[:n_ground] = rng.uniform(-road_half, road_half, n_ground)
    y[:n_ground] = 1.65 + rng.uniform(-0.05, 0.05, n_ground)
    side = np.where(rng.uniform(size=n_points - n_ground) < 0.5, -1.0, 1.0)
    lat[n_ground:] = side * wall_x + rng.uniform(
        -0.3, 0.3, n_points - n_ground
    )
    y[n_ground:] = rng.uniform(wall_top, 1.65, n_points - n_ground)
    pts = np.stack(
        [px + lat * perp[:, 0], y, pz + lat * perp[:, 1]], axis=-1
    )

    # Per-sprite appearance diversity — real scenes do not consist of
    # identical squares: random size (via an elliptical soft support),
    # brightness and contrast per sprite, so descriptors can discriminate.
    patches = rng.uniform(40.0, 255.0, (n_points, patch, patch)).astype(np.float32)
    lum = rng.uniform(0.55, 1.0, (n_points, 1, 1)).astype(np.float32)
    patches *= lum
    r = patch // 2
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    ax = rng.uniform(0.45, 1.0, (n_points, 2)).astype(np.float32) * r
    th = rng.uniform(0, np.pi, n_points).astype(np.float32)
    c, s = np.cos(th), np.sin(th)
    u = (
        c[:, None, None] * xx[None] + s[:, None, None] * yy[None]
    ) / ax[:, 0, None, None]
    v = (
        -s[:, None, None] * xx[None] + c[:, None, None] * yy[None]
    ) / ax[:, 1, None, None]
    inside = (u * u + v * v) <= 1.0
    # outside the ellipse the sprite shows dim residual texture instead of
    # a hard common silhouette
    patches = np.where(inside, patches, patches * 0.08)

    if hard:
        # Low-texture stretch: for ~12 % of the path most landmarks vanish
        # and the survivors' contrast drops near the FAST threshold.
        lo, hi = n_frames * 0.25, n_frames * 0.37
        in_stretch = (t >= lo) & (t < hi)
        drop = in_stretch & (rng.uniform(size=n_points) < 0.85)
        pts[drop, 1] = 1e6  # shove dropped points far underground
        weak = in_stretch & ~drop
        mean = patches[weak].mean(axis=(1, 2), keepdims=True)
        patches[weak] = mean + (patches[weak] - mean) * 0.3

    # light smoothing so sub-pixel shifts look natural
    k = np.array([0.25, 0.5, 0.25])
    patches = np.apply_along_axis(
        lambda v: np.convolve(v, k, mode="same"), 1, patches
    )
    patches = np.apply_along_axis(
        lambda v: np.convolve(v, k, mode="same"), 2, patches
    )

    occ_pos = occ_patches = None
    noise_sigma = gain_amp = bias_amp = 0.0
    if highway:
        # mild sensor noise + slight exposure wander; the stressor here is
        # the motion itself, not the photometrics
        noise_sigma, gain_amp, bias_amp = 2.0, 0.05, 2.0
    if hard:
        # Independently moving near-field occluders ("oncoming traffic"):
        # each spawns ahead of the camera at some frame and drives back
        # toward it, violating the rigid-world assumption for any feature
        # matched on it.
        n_occ = 10
        occ_q = 31
        occ_pos = np.full((n_frames, n_occ, 3), 1e6, dtype=np.float64)
        yaws_f = np.unwrap(
            np.arctan2(poses_T_w_c[:, 0, 2], poses_T_w_c[:, 2, 2])
        )
        for o in range(n_occ):
            f0 = int(rng.uniform(0, n_frames * 0.9))
            h = np.array([np.sin(yaws_f[f0]), 0.0, np.cos(yaws_f[f0])])
            perp3 = np.array([np.cos(yaws_f[f0]), 0.0, -np.sin(yaws_f[f0])])
            start = (
                poses_T_w_c[f0, :3, 3]
                + h * rng.uniform(30.0, 60.0)
                + perp3 * rng.uniform(-3.5, 3.5)
            )
            start[1] = 0.6
            vel = -h * rng.uniform(0.8, 1.6)  # oncoming, m/frame
            life = int(rng.uniform(40, 100))
            for f in range(f0, min(f0 + life, n_frames)):
                occ_pos[f, o] = start + vel * (f - f0)
        occ_patches = rng.uniform(60.0, 230.0, (n_occ, occ_q, occ_q)).astype(
            np.float32
        )
        occ_patches = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), 1, occ_patches
        )
        occ_patches = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), 2, occ_patches
        ).astype(np.float32)
        noise_sigma, gain_amp, bias_amp = 3.0, 0.12, 6.0

    sizes = occ_sizes = None
    if scaled_sprites:
        # physical sizes: pixel footprint = fx*size/z (13 px at ~25-55 m)
        sizes = rng.uniform(0.45, 1.0, n_points).astype(np.float32)
        if occ_patches is not None:
            occ_sizes = rng.uniform(1.2, 2.2, len(occ_patches)).astype(
                np.float32
            )

    T_c_w = np.array([np.linalg.inv(T) for T in poses_T_w_c])
    return SyntheticWorld(
        pts,
        patches.astype(np.float32),
        T_c_w,
        config,
        profile=profile,
        sizes=sizes,
        occ_pos=occ_pos,
        occ_patches=occ_patches,
        occ_sizes=occ_sizes,
        noise_sigma=noise_sigma,
        gain_amp=gain_amp,
        bias_amp=bias_amp,
    )


def make_wall_world(
    config: Config,
    n_frames: int = 20,
    speed: float = 1.5,
    wall_z: float = 40.0,
    n_points: int = 3000,
    patch: int = 13,
    seed: int = 0,
) -> SyntheticWorld:
    """Head-on approach to a textured wall with PHYSICALLY-SIZED sprites:
    appearance scale grows as 1/z while the camera closes in — the scale-
    robustness scenario (single-scale descriptors decorrelate; an image
    pyramid keeps some level pair aligned within one scale step)."""
    rng = np.random.default_rng(seed)
    poses_T_w_c = []
    for f in range(n_frames):
        poses_T_w_c.append(
            _se3_from_yaw_pos(0.0, np.array([0.0, 0.0, speed * f]))
        )
    poses_T_w_c = np.stack(poses_T_w_c)

    # wall plane + a light ground strip for pose conditioning
    n_wall = int(n_points * 0.8)
    pts = np.empty((n_points, 3))
    pts[:n_wall, 0] = rng.uniform(-30.0, 30.0, n_wall)
    pts[:n_wall, 1] = rng.uniform(-8.0, 1.65, n_wall)
    pts[:n_wall, 2] = wall_z + rng.uniform(-0.2, 0.2, n_wall)
    n_g = n_points - n_wall
    pts[n_wall:, 0] = rng.uniform(-12.0, 12.0, n_g)
    pts[n_wall:, 1] = 1.65 + rng.uniform(-0.05, 0.05, n_g)
    pts[n_wall:, 2] = rng.uniform(2.0, wall_z, n_g)

    patches = rng.uniform(40.0, 255.0, (n_points, patch, patch)).astype(
        np.float32
    )
    patches *= rng.uniform(0.55, 1.0, (n_points, 1, 1)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    patches = np.apply_along_axis(
        lambda v: np.convolve(v, k, mode="same"), 1, patches
    )
    patches = np.apply_along_axis(
        lambda v: np.convolve(v, k, mode="same"), 2, patches
    ).astype(np.float32)
    # physical sizes tuned so wall sprites are ~8-14 px at the start and
    # grow ~4x by the closest approach
    sizes = rng.uniform(0.35, 0.7, n_points).astype(np.float32)

    T_c_w = np.array([np.linalg.inv(T) for T in poses_T_w_c])
    return SyntheticWorld(
        pts, patches, T_c_w, config, profile="wall", sizes=sizes
    )


def _paste(
    img: np.ndarray, patch: np.ndarray, v: float, u: float, scale: float = 1.0
):
    """Opaque paste of `patch` centered at float coords (v, u), shifted to
    sub-pixel position by bilinear resampling; `scale` magnifies the sprite
    (perspective size when the world uses scaled sprites). Replaces (does not
    blend with) what is underneath — callers draw far-to-near (painter's
    algorithm) so each pixel shows exactly one surface with well-defined
    depth."""
    P = patch.shape[0]
    H, W = img.shape
    if abs(scale - 1.0) < 1e-3:
        r = P // 2
        vi, ui = int(np.floor(v)), int(np.floor(u))
        fv, fu = v - vi, u - ui
        # bilinearly shift the patch by (fv, fu); result is (P-1, P-1) fully
        # covered by patch support (no border bleed)
        shifted = (
            patch[:-1, :-1] * (1 - fv) * (1 - fu)
            + patch[:-1, 1:] * (1 - fv) * fu
            + patch[1:, :-1] * fv * (1 - fu)
            + patch[1:, 1:] * fv * fu
        )
        Q = P - 1
        y0 = vi - r + 1
        x0 = ui - r + 1
    else:
        # render the sprite at `scale` times its natural size: sample the
        # patch at output-pixel centers mapped back through the scaling
        Q = max(int(round((P - 1) * scale)), 2)
        if Q > 4 * max(H, W):
            return  # degenerate giant sprite
        y0 = int(np.floor(v)) - Q // 2
        x0 = int(np.floor(u)) - Q // 2
        oy = (np.arange(Q) + y0 - v) / scale + (P - 1) / 2.0
        ox = (np.arange(Q) + x0 - u) / scale + (P - 1) / 2.0
        iy = np.clip(oy, 0.0, P - 1.001)
        ix = np.clip(ox, 0.0, P - 1.001)
        y0i = iy.astype(int)
        x0i = ix.astype(int)
        fy = (iy - y0i)[:, None]
        fx = (ix - x0i)[None, :]
        shifted = (
            patch[y0i][:, x0i] * (1 - fy) * (1 - fx)
            + patch[y0i][:, x0i + 1] * (1 - fy) * fx
            + patch[y0i + 1][:, x0i] * fy * (1 - fx)
            + patch[y0i + 1][:, x0i + 1] * fy * fx
        )
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + Q, H), min(x0 + Q, W)
    if ye <= ys or xe <= xs:
        return
    img[ys:ye, xs:xe] = shifted[ys - y0 : ye - y0, xs - x0 : xe - x0]


def _background(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Dark, low-contrast sky (contrast well under the FAST threshold, so it
    contributes no corners and no false stereo structure). Smooth large-scale
    variation adds a little photometric context without creating corners."""
    base = rng.uniform(8.0, 16.0, (h, w)).astype(np.float32)
    coarse = rng.uniform(-4.0, 4.0, (h // 32 + 2, w // 32 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int); x0 = xs.astype(int)
    fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
    smooth = (
        coarse[y0][:, x0] * (1 - fy) * (1 - fx)
        + coarse[y0][:, x0 + 1] * (1 - fy) * fx
        + coarse[y0 + 1][:, x0] * fy * (1 - fx)
        + coarse[y0 + 1][:, x0 + 1] * fy * fx
    )
    return (base + smooth).astype(np.float32)


def render_frame(
    world: SyntheticWorld, frame_idx: int, seed: int = 1234
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (left, right) grayscale f32 images for a frame."""
    cfg = world.config
    cam = cfg.camera
    h, w = cfg.image_hw
    T_c_w = world.poses_T_c_w[frame_idx]
    pts = world.points
    patches = world.patches
    if world.occ_pos is not None:
        # moving occluders join this frame's point set (at their CURRENT
        # positions) and compete in the same painter's sort
        pts = np.concatenate([pts, world.occ_pos[frame_idx]], axis=0)
    Xc = pts @ T_c_w[:3, :3].T + T_c_w[:3, 3]

    vis = (Xc[:, 2] > 2.0) & (Xc[:, 2] < 180.0)
    rng = np.random.default_rng(seed)  # deterministic background per world
    bg = _background(h, w, rng)
    left = bg.copy()
    right = bg.copy()

    n_static = len(world.points)
    idx = np.nonzero(vis)[0]
    z = Xc[idx, 2]
    # painter's algorithm: draw far sprites first so near ones occlude them
    order = np.argsort(-z)
    idx = idx[order]
    z = z[order]
    u = cam.fx * Xc[idx, 0] / z + cam.cx
    v = cam.fy * Xc[idx, 1] / z + cam.cy
    disp = cam.fx * cam.baseline / z
    margin = 8
    for k in range(len(idx)):
        if idx[k] < n_static:
            patch = patches[idx[k]]
            size = None if world.sizes is None else world.sizes[idx[k]]
        else:
            patch = world.occ_patches[idx[k] - n_static]
            size = (
                None
                if world.occ_sizes is None
                else world.occ_sizes[idx[k] - n_static]
            )
        if size is None:
            scale = 1.0
        else:
            scale = cam.fx * size / z[k] / (patch.shape[0] - 1)
        m = margin * max(scale, 1.0)
        if -m < u[k] < w + m and -m < v[k] < h + m:
            _paste(left, patch, v[k], u[k], scale)
        ur = u[k] - disp[k]
        if -m < ur < w + m and -m < v[k] < h + m:
            _paste(right, patch, v[k], ur, scale)

    if world.noise_sigma > 0 or world.gain_amp > 0:
        # per-frame exposure/gain drift, L/R gain mismatch, sensor noise
        prng = np.random.default_rng((seed, frame_idx))
        gain = 1.0 + world.gain_amp * np.sin(2 * np.pi * frame_idx / 47.0)
        bias = world.bias_amp * np.sin(2 * np.pi * frame_idx / 31.0)
        gain_r = gain * (1.0 + 0.03 * np.sin(2 * np.pi * frame_idx / 13.0))
        left = left * gain + bias + prng.normal(0, world.noise_sigma, left.shape)
        right = (
            right * gain_r + bias + prng.normal(0, world.noise_sigma, right.shape)
        )

    return np.clip(left, 0, 255), np.clip(right, 0, 255)


def frames(world: SyntheticWorld) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    for f in range(world.poses_T_c_w.shape[0]):
        left, right = render_frame(world, f)
        yield f, left, right
