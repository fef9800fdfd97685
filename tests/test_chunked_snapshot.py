"""Snapshot / resume for the production chunked core.

The per-frame RNG is keyed on the frame id (slam_core.make_chunk_step), so
chunk boundaries are semantically invisible: stopping mid-sequence, saving
the carry, and resuming in a fresh driver must reproduce the uninterrupted
run BIT-EXACTLY — and a partial final chunk must reuse the same compiled
program (active-mask padding, no recompile).
"""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config

N_FRAMES = 13  # deliberately NOT a multiple of the chunk size


@pytest.fixture(scope="module")
def rendered():
    world = synthetic.make_world(
        Config(), n_frames=N_FRAMES, n_points=8000, seed=0
    )
    return world, [(f, l, r) for f, l, r in synthetic.frames(world)]


def test_snapshot_resume_bit_exact(rendered, tmp_path):
    world, frames = rendered
    cfg = world.config

    # uninterrupted run
    ref = ChunkedSlam(cfg, chunk=4)
    for f, l, r in frames:
        ref.process(f, l, r)
    ref.finish()

    # stop after 7 frames (mid-chunk!), snapshot, resume in a new driver
    path = str(tmp_path / "state.npz")
    a = ChunkedSlam(cfg, chunk=4)
    for f, l, r in frames[:7]:
        a.process(f, l, r)
    a.save_snapshot(path)

    b = ChunkedSlam(cfg, chunk=4)
    b.load_snapshot(path)
    for f, l, r in frames[7:]:
        b.process(f, l, r)
    b.finish()

    # resumed tail == uninterrupted run, bit-exact
    for f in sorted(b.estimates):
        if f < 7:
            continue
        assert f in ref.estimates
        np.testing.assert_array_equal(
            b.estimates[f], ref.estimates[f], err_msg=f"frame {f}"
        )
    ref_states = {
        s["frame_id"]: s["state"] for s in ref.stats if s["frame_id"] >= 7
    }
    b_states = {s["frame_id"]: s["state"] for s in b.stats}
    assert b_states == ref_states


def test_partial_chunk_no_new_compile(rendered):
    """Padding a short final chunk keeps the dispatch on the same compiled
    program (the VERDICT-flagged recompile), and pads produce no records."""
    import jax

    world, frames = rendered
    slam = ChunkedSlam(world.config, chunk=4)
    with jax.log_compiles(False):
        for f, l, r in frames:  # 13 = 3 full chunks + 1 partial
            slam.process(f, l, r)
        n_compiles_before = slam.chunk_step._cache_size()
        slam.finish()
        n_compiles_after = slam.chunk_step._cache_size()
    assert n_compiles_after == n_compiles_before, (
        "the short final chunk must not trigger a new compile"
    )
    # exactly one record per real frame, none for the padding
    assert sorted(s["frame_id"] for s in slam.stats) == list(range(N_FRAMES))
