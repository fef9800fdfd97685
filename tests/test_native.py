"""Tests for the native host runtime (native/src/slamio.cpp via ctypes).

Covers: PNG/PGM grayscale decode vs PIL, the multithreaded prefetching
stereo loader (in-order delivery, content correctness), and the native
KITTI trajectory writer vs the pure-Python writer (same rows, reference
format of map.cpp:188-195).
"""

import os

import numpy as np
import pytest

from stereo_visual_slam.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native slamio library not available"
)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr, mode="L").save(path)


def _write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def test_png_decode_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
    p = str(tmp_path / "img.png")
    _write_png(p, arr)
    out = native.read_image_gray(p)
    np.testing.assert_array_equal(out, arr)


def test_pgm_decode(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, size=(12, 19), dtype=np.uint8)
    p = str(tmp_path / "img.pgm")
    _write_pgm(p, arr)
    out = native.read_image_gray(p)
    np.testing.assert_array_equal(out, arr)


def test_probe_and_bad_file(tmp_path):
    arr = np.zeros((5, 9), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    _write_png(p, arr)
    assert native.probe_image(p) == (5, 9)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    with pytest.raises(IOError):
        native.probe_image(bad)


def _make_sequence(tmp_path, n, h=24, w=32):
    left_dir = tmp_path / "image_0"
    right_dir = tmp_path / "image_1"
    left_dir.mkdir()
    right_dir.mkdir()
    rng = np.random.default_rng(7)
    frames = []
    for i in range(n):
        l = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        r = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        _write_png(str(left_dir / f"{i:06d}.png"), l)
        _write_png(str(right_dir / f"{i:06d}.png"), r)
        frames.append((l, r))
    return str(left_dir), str(right_dir), frames


def test_prefetcher_in_order_and_correct(tmp_path):
    n = 25
    left_dir, right_dir, frames = _make_sequence(tmp_path, n)
    got = []
    with native.StereoPrefetcher(
        left_dir, right_dir, count=n, hw=(24, 32), depth=4, workers=3
    ) as pf:
        for idx, l, r in pf:
            got.append(idx)
            np.testing.assert_array_equal(l, frames[idx][0])
            np.testing.assert_array_equal(r, frames[idx][1])
    assert got == list(range(n))


def test_prefetcher_early_close(tmp_path):
    n = 16
    left_dir, right_dir, _ = _make_sequence(tmp_path, n)
    pf = native.StereoPrefetcher(
        left_dir, right_dir, count=n, hw=(24, 32), depth=4, workers=2
    )
    it = iter(pf)
    next(it)
    next(it)
    pf.close()  # must join workers without deadlock


def test_kitti_sequence_uses_native(tmp_path):
    from stereo_visual_slam.data import kitti

    n = 5
    _make_sequence(tmp_path, n)
    seq = kitti.open_sequence(str(tmp_path))
    assert seq.n_frames == n
    out = list(seq.frames())
    assert [i for i, _, _ in out] == list(range(n))
    l0, _ = seq.frame(0)
    np.testing.assert_array_equal(out[0][1], l0)


def test_traj_writer_matches_python(tmp_path):
    from stereo_visual_slam.pipeline import trajectory

    rng = np.random.default_rng(3)
    poses = []
    for _ in range(6):
        # random rigid transform
        A = rng.normal(size=(3, 3))
        Q, _ = np.linalg.qr(A)
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        T = np.eye(4)
        T[:3, :3] = Q
        T[:3, 3] = rng.normal(scale=5.0, size=3)
        poses.append(T)

    py_path = str(tmp_path / "py.txt")
    na_path = str(tmp_path / "native.txt")
    pyw = trajectory.TrajectoryWriter(py_path)
    with native.NativeTrajectoryWriter(na_path) as nw:
        for i, T in enumerate(poses):
            pyw.write(i * 3, T)
            nw.write(i * 3, T)
        nw.flush()

    py_rows = trajectory.read_trajectory(py_path)
    na_rows = trajectory.read_trajectory(na_path)
    assert set(py_rows) == set(na_rows)
    for k in py_rows:
        np.testing.assert_allclose(na_rows[k], py_rows[k], rtol=0, atol=1e-7)


def test_traj_writer_append(tmp_path):
    p = str(tmp_path / "t.txt")
    T = np.eye(4)
    with native.NativeTrajectoryWriter(p) as w:
        w.write(0, T)
    with native.NativeTrajectoryWriter(p, append=True) as w:
        w.write(1, T)
    with open(p) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("0 ") and lines[1].startswith("1 ")


# ---------------------------------------------------------------------------
# Native map store (native/src/mapstore.cpp) vs the Python oracle
# (mapping/store.py) — randomized operation-sequence equivalence.
# ---------------------------------------------------------------------------


def _small_cfg():
    from stereo_visual_slam.utils.config import small_config

    return small_config()


def _random_kf(rng, cfg, kf_id, frame_id, store, next_ids):
    """Build one random Keyframe referencing a mix of existing + new
    landmarks, mirroring what the pipeline does per keyframe."""
    from stereo_visual_slam.mapping.store import Keyframe

    N = cfg.frontend.max_raw_keypoints
    n_new = int(rng.integers(5, 40))
    ids_new = np.arange(next_ids, next_ids + n_new, dtype=np.int64)
    pos_new = rng.normal(0, 20, (n_new, 3)).astype(np.float32)
    rel_new = rng.uniform(size=n_new) < 0.7
    rows = np.full(N, -1, np.int32)
    valid = np.zeros(N, bool)
    uv = np.zeros((N, 2), np.float32)

    # observe some existing landmarks
    state_rows = np.nonzero(store.alive)[0]
    n_old = min(len(state_rows), int(rng.integers(0, 60)))
    if n_old:
        pick = rng.choice(state_rows, n_old, replace=False).astype(np.int32)
        rows[:n_old] = pick
        valid[:n_old] = True
        uv[:n_old] = rng.uniform(0, 500, (n_old, 2)).astype(np.float32)
    return (
        Keyframe(
            keyframe_id=kf_id,
            frame_id=frame_id,
            T_c_w=_rand_pose(rng),
            rows=rows,
            uv=uv,
            valid=valid,
        ),
        ids_new,
        pos_new,
        rel_new,
    )


def _rand_pose(rng):
    th = rng.normal(0, 0.2, 3)
    a = np.linalg.norm(th) + 1e-12
    k = th / a
    Kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    R = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.astype(np.float32)
    T[:3, 3] = rng.normal(0, 2.0, 3).astype(np.float32)
    return T


def test_native_mapstore_equivalence(rng):
    """Drive the SAME random op sequence through the Python oracle and the
    native store; arena state, counts, eviction choices, and the assembled
    BA window must agree exactly."""
    from stereo_visual_slam.mapping.store import MapStore

    cfg = _small_cfg()
    py = MapStore(cfg)
    nat = native.NativeMapStore(cfg)

    next_id = 0
    for step in range(30):
        kf, ids_new, pos_new, rel_new = _random_kf(
            rng, cfg, kf_id=step, frame_id=step * 2, store=py,
            next_ids=next_id,
        )
        next_id += len(ids_new)
        # spawn new landmarks in both, then observe them in this keyframe
        py.spawn(ids_new, pos_new, rel_new)
        nat.spawn(ids_new, pos_new, rel_new)
        new_rows_py = py.rows_of(ids_new)
        new_rows_nat = nat.rows_of(ids_new)
        np.testing.assert_array_equal(new_rows_py, new_rows_nat)
        # fill the keyframe's tail slots with the new landmarks
        n_used = int(kf.valid.sum())
        m = min(len(ids_new), len(kf.rows) - n_used)
        kf.rows[n_used : n_used + m] = new_rows_py[:m]
        kf.valid[n_used : n_used + m] = True
        kf.uv[n_used : n_used + m] = rng.uniform(0, 500, (m, 2)).astype(
            np.float32
        )

        py.insert_keyframe(kf)
        nat.insert_keyframe(kf)

        # occasional upgrade of some live rows
        if step % 3 == 2:
            live = np.nonzero(py.alive)[0]
            n_up = min(len(live), 7)
            rows_up = live[:n_up].astype(np.int32)
            pos_up = rng.normal(0, 20, (n_up, 3)).astype(np.float32)
            py.upgrade(rows_up, pos_up)
            nat.upgrade(rows_up, pos_up)

        assert py.n_keyframes() == nat.n_keyframes()
        assert py.n_landmarks() == nat.n_landmarks(), f"step {step}"

        st = nat.arena_state()
        np.testing.assert_array_equal(py.alive, st["alive"][: len(py.alive)])
        np.testing.assert_array_equal(
            py.obs_count, st["obs_count"][: len(py.obs_count)]
        )
        np.testing.assert_array_equal(py.row_id, st["row_id"][: len(py.row_id)])
        live = py.alive
        np.testing.assert_array_equal(py.pos[live], st["pos"][: len(live)][live])
        np.testing.assert_array_equal(
            py.reliable[live], st["reliable"][: len(live)][live]
        )

        # same eviction history
        assert len(py.evicted) == nat._lib.ms_evicted_count(nat._handle)

        # identical BA window assembly
        out_py = py.assemble_schedule_input()
        out_nat = nat.assemble_schedule_input()
        assert (out_py is None) == (out_nat is None)
        if out_py is not None:
            arrays_py, kf_ids_py, sel_py = out_py
            arrays_nat, kf_ids_nat, sel_nat = out_nat
            np.testing.assert_array_equal(kf_ids_py, kf_ids_nat)
            np.testing.assert_array_equal(sel_py, sel_nat)
            for k in arrays_py:
                np.testing.assert_array_equal(
                    arrays_py[k], arrays_nat[k], err_msg=k
                )

    # eviction queue contents agree (pop order + payload)
    for kf in py.evicted:
        got = nat.pop_evicted()
        assert got is not None
        kid, fid, T = got
        assert kid == kf.keyframe_id and fid == kf.frame_id
        np.testing.assert_array_equal(T, np.asarray(kf.T_c_w, np.float32))
    assert nat.pop_evicted() is None


def test_native_mapstore_write_back(rng):
    """BA write-back applies poses to live keyframes and verdicts to live
    rows identically in both stores."""
    from stereo_visual_slam.mapping.store import MapStore

    cfg = _small_cfg()
    py = MapStore(cfg)
    nat = native.NativeMapStore(cfg)
    next_id = 0
    for step in range(12):
        kf, ids_new, pos_new, rel_new = _random_kf(
            rng, cfg, kf_id=step, frame_id=step, store=py, next_ids=next_id
        )
        next_id += len(ids_new)
        py.spawn(ids_new, pos_new, rel_new)
        nat.spawn(ids_new, pos_new, rel_new)
        rows_new = py.rows_of(ids_new)
        n_used = int(kf.valid.sum())
        m = min(len(ids_new), len(kf.rows) - n_used)
        kf.rows[n_used : n_used + m] = rows_new[:m]
        kf.valid[n_used : n_used + m] = True
        py.insert_keyframe(kf)
        nat.insert_keyframe(kf)

    out_py = py.assemble_schedule_input()
    arrays, kf_ids, sel = out_py
    nK = len(kf_ids)
    T_new = np.stack([_rand_pose(rng) for _ in range(nK)])
    verdict = (rng.uniform(size=len(sel)) < 0.8).astype(np.float32)
    py.write_back_schedule(kf_ids, sel, T_new, verdict)
    nat.write_back_schedule(kf_ids, sel, T_new, verdict)

    st = nat.arena_state()
    np.testing.assert_array_equal(py.inlier, st["inlier"][: len(py.inlier)])
    a_py = py.assemble_schedule_input()[0]
    a_nat = nat.assemble_schedule_input()[0]
    for k in a_py:
        np.testing.assert_array_equal(a_py[k], a_nat[k], err_msg=k)
