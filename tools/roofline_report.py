"""Per-phase FLOP / HBM-byte / MFU table of the production programs.

FLOPs and bytes come from XLA's post-optimization cost model on the
compiled executables (utils/roofline.py); the device times are measured on
the same GPU and passed on the command line:

    python tools/roofline_report.py <chunk_ms> <extract_ms> <scan_ms> <ba_ms>

Caveat: the cost model counts while/cond BODIES ONCE — the feats scan is
reported per frame (its body is one frame), and the BA schedule's LM
iterations are undercounted by the iteration count; treat BA FLOPs as a
lower bound.
"""

import sys

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import schedule as ba_schedule
from stereo_visual_slam.models import frontend as frontend_mod
from stereo_visual_slam.models import slam_core
from stereo_visual_slam.utils import roofline
from stereo_visual_slam.utils.cache import enable_compilation_cache
from stereo_visual_slam.utils.config import Config

B = 8


def main():
    enable_compilation_cache()
    cfg = Config()
    H, W = cfg.padded_hw
    L, Kw = cfg.ba.max_landmarks, cfg.keyframe.window_size
    f32, i32, u8 = jnp.float32, jnp.int32, jnp.uint8
    S = jax.ShapeDtypeStruct

    im_sds = S((B, 2, H, W), u8)
    carry_sds = jax.eval_shape(lambda: slam_core.init_carry(cfg))
    key_sds = S((2,), jnp.uint32)

    batch_extract = frontend_mod.make_batch_extractor(cfg)
    feats_sds = jax.eval_shape(batch_extract, im_sds)
    f1_sds = jax.tree.map(lambda s: S(s.shape[1:], s.dtype), feats_sds)
    feats_step = jax.jit(slam_core.make_feats_step(cfg))
    chunk_step = slam_core.make_chunk_step(cfg)
    schedule = ba_schedule.make_ba_schedule(cfg.ba)
    inp_sds = ba_schedule.ScheduleInput(
        T_c_w=S((Kw, 4, 4), f32), points=S((L, 3), f32),
        uv=S((L, Kw, 2), f32), obs_mask=S((L, Kw), f32), inlier=S((L,), f32),
        reliable=S((L,), f32), present=S((L,), f32), pose_mask=S((Kw,), f32),
        fixed_pose=S((Kw,), f32))

    if len(sys.argv) != 5:
        raise SystemExit(__doc__)
    t_chunk, t_ext, t_scan, t_ba = (float(a) for a in sys.argv[1:])

    rows = [
        ("chunk_step (B=8, no-BA)", roofline.cost_of(
            chunk_step, carry_sds, im_sds, S((B,), i32), S((B,), jnp.bool_),
            key_sds), t_chunk),
        ("batch_extract (B=8)", roofline.cost_of(batch_extract, im_sds),
         t_ext),
        ("feats step (1 frame)", roofline.cost_of(
            feats_step, carry_sds, f1_sds, S((), i32), key_sds),
         t_scan / B),
        ("BA schedule (1 keyframe, lower bound)", roofline.cost_of(
            schedule, inp_sds, S((3, 3), f32)), t_ba),
    ]
    power_w = roofline.power_limit_w()
    for label, cost, ms in rows:
        print(roofline.summarize(label, cost, ms * 1e-3, power_w), flush=True)


if __name__ == "__main__":
    main()
