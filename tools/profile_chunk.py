"""Where does the bench's per-frame wall time actually go?

Times the PRODUCTION chunk program (models/slam_core.make_chunk_step) on
real synthetic frames: per-chunk dispatch->ready wall time on live state,
plus the ChunkedSlam host-phase timing dict for the same run.
"""

import time

import jax
import numpy as np

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.models import slam_core
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.cache import enable_compilation_cache
from stereo_visual_slam.utils.config import Config


def main():
    enable_compilation_cache()
    chunk = 8
    n_chunks = 16
    cfg = Config()
    world = synthetic.make_world(
        cfg, n_frames=chunk * (n_chunks + 2), n_points=8000, seed=0
    )
    frames = [(f, l, r) for f, l, r in synthetic.frames(world)]
    H, W = cfg.padded_hw

    chunk_step = slam_core.make_chunk_step(cfg)
    carry = slam_core.init_carry(cfg)
    key = jax.random.PRNGKey(0)

    def upload(batch):
        stacked = np.zeros((chunk, 2, H, W), np.uint8)
        fids = np.zeros((chunk,), np.int32)
        for i, (fid, left, right) in enumerate(batch):
            h, w = left.shape
            stacked[i, 0, :h, :w] = left
            stacked[i, 1, :h, :w] = right
            fids[i] = fid
        return (
            jax.device_put(stacked),
            jax.device_put(fids),
            jax.device_put(np.ones((chunk,), bool)),
        )

    # warmup compile
    t0 = time.perf_counter()
    imgs, fids, act = upload(frames[:chunk])
    carry, recs = chunk_step(carry, imgs, fids, act, key)
    jax.block_until_ready(carry)
    print(f"compile+first chunk: {time.perf_counter() - t0:.1f}s", flush=True)

    # timed per-chunk, serialized (upload ready before dispatch; block after)
    per_chunk = []
    kf_per_chunk = []
    for ci in range(1, n_chunks + 1):
        batch = frames[ci * chunk : (ci + 1) * chunk]
        imgs, fids, act = upload(batch)
        jax.block_until_ready(imgs)
        t0 = time.perf_counter()
        carry, recs = chunk_step(carry, imgs, fids, act, key)
        jax.block_until_ready(carry)
        dt = time.perf_counter() - t0
        nkf = int(np.asarray(jax.device_get(recs.is_keyframe)).sum())
        per_chunk.append(dt)
        kf_per_chunk.append(nkf)
        print(f"chunk {ci:3d}: {dt*1e3:8.1f} ms  kf={nkf}", flush=True)

    per_chunk = np.array(per_chunk)
    kf = np.array(kf_per_chunk)
    # regress chunk time = a + b*nkf  ->  track cost/frame, BA cost/kf
    A = np.stack([np.ones_like(kf, float), kf.astype(float)], -1)
    coef, *_ = np.linalg.lstsq(A, per_chunk, rcond=None)
    print(
        f"\nmean {per_chunk.mean()*1e3:.1f} ms/chunk "
        f"({per_chunk.mean()/chunk*1e3:.1f} ms/frame), "
        f"kf rate {kf.sum()/(len(kf)*chunk):.2f}"
    )
    print(
        f"fit: base {coef[0]*1e3:.1f} ms/chunk "
        f"({coef[0]/chunk*1e3:.2f} ms/frame track-only) "
        f"+ {coef[1]*1e3:.1f} ms/keyframe"
    )

    # same run through ChunkedSlam to get the host-phase view
    slam = ChunkedSlam(cfg, chunk=chunk)
    slam.warmup()
    t0 = time.perf_counter()
    for f, left, right in frames[: chunk * n_chunks]:
        slam.process(f, left, right)
    slam.finish()
    wall = time.perf_counter() - t0
    print(
        f"\nChunkedSlam wall: {wall:.2f}s for {chunk*n_chunks} frames "
        f"({wall/(chunk*n_chunks)*1e3:.1f} ms/frame)"
    )
    print("timing:", {k: round(v, 3) for k, v in slam.timing.items()})


if __name__ == "__main__":
    main()
