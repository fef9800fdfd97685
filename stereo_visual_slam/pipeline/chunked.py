"""Chunked host driver for the device-resident SLAM core — the PRODUCTION
driver (run_vslam.py dispatches here by default).

The host's job: stack B frames, upload, dispatch the scanned chunk program
(models/slam_core.py), and fetch the per-frame records. Transfers stay off
the dispatch path:

  * an upload pool assembles + device_puts each chunk's images and sideband
    (frame ids + active mask) ahead of time (depth `prefetch`),
  * the main thread dispatches chunk programs in carry order,
  * per-frame records are packed into ONE (B, R) f32 matrix by a tiny jitted
    kernel (one fetch per chunk instead of one per pytree leaf) and fetched
    on the main thread a few chunks BEHIND the newest dispatch, so the
    blocking device_get targets a chunk that has already finished.

Steady-state wall time per frame approaches pure device throughput; the
host adds only dispatch cost.

Semantics equal pipeline/vo.py with lookahead=0 (exact reference
sequencing, BA feedback on the very next frame) — this driver simply moves
the map + state machine out of Python and into the scan carry.

Partial chunks (the sequence tail, or a flush before a snapshot) are padded
to the static chunk size with `active=False` slots, so every dispatch hits
the same compiled program. The per-frame RNG is keyed on the frame id with
a run-constant base key, making results independent of chunk boundaries:
stop/snapshot/resume at any frame reproduces the uninterrupted run
bit-exactly.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import functools
import threading
from typing import Deque, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.models import slam_core
from stereo_visual_slam.pipeline.trajectory import TrajectoryWriter
from stereo_visual_slam.utils.config import Config
from stereo_visual_slam.utils.hostconst import build_on_host


class _KeyframeView:
    def __init__(self, frame_id: int, T_c_w: np.ndarray):
        self.frame_id = frame_id
        self.keyframe_id = frame_id
        self.T_c_w = T_c_w


class _MapView:
    """Read-only MapStore-shaped view of a fetched device MapState (the
    fields pipeline/viz consumes: pos, alive, inlier, keyframes)."""

    def __init__(self, mstate):
        self.pos = np.asarray(mstate.pos)
        self.alive = np.asarray(mstate.obs_mask.max(axis=1) > 0)
        self.inlier = np.asarray(mstate.inlier) & self.alive
        self.keyframes = {}
        for slot in range(len(mstate.kf_frame_id)):
            fid = int(mstate.kf_frame_id[slot])
            if fid >= 0:
                self.keyframes[fid] = _KeyframeView(
                    fid, np.asarray(mstate.kf_T[slot])
                )


@functools.lru_cache(maxsize=1)
@build_on_host
def _make_record_packer():
    """Jitted FrameRecord -> (B, 48) f32 packer: scalars in columns 0..13,
    T_c_w rows 14..29, evict_T rows 30..45 (frame ids <= 2^24 are exact in
    f32). One array out = ONE fetch per chunk.

    Process-wide singleton (lru_cache): a per-instance jit object would
    re-trace and re-load its executable for every ChunkedSlam constructed —
    the bench constructs one per timed run and per robustness profile."""

    @jax.jit
    def pack(recs: slam_core.FrameRecord) -> jnp.ndarray:
        cols = [
            recs.active, recs.frame_id, recs.tracked, recs.lost,
            recs.is_keyframe, recs.n_matches, recs.n_inliers, recs.n_new,
            recs.twist, recs.angle_y, recs.ba_ran, recs.ba_cost,
            recs.evict_valid, recs.evict_frame_id,
        ]
        head = jnp.stack([c.astype(jnp.float32) for c in cols], axis=-1)
        B = head.shape[0]
        return jnp.concatenate(
            [
                head,
                recs.T_c_w.reshape(B, 16),
                recs.evict_T.reshape(B, 16),
                jnp.zeros((B, 2), jnp.float32),
            ],
            axis=-1,
        )

    return pack


class ChunkedSlam:
    def __init__(
        self,
        config: Config,
        chunk: int = 8,
        pose_path: Optional[str] = None,
        seed: int = 0,
        mesh=None,
        prefetch: int = 3,
    ):
        self.config = config
        self.chunk = chunk
        self.mesh = mesh
        self.chunk_step = slam_core.make_chunk_step(config, mesh=mesh)
        # production dispatch path: ONE flat uint8 upload per chunk (images +
        # frame ids + active mask in one device_put)
        self._packed_step = slam_core.make_chunk_step_packed(
            config, mesh=mesh, chunk=chunk
        )
        # assemble the initial carry in HOST memory (init_carry is ~20 small
        # eager ops), then ship it to the accelerator in one device_put
        from stereo_visual_slam.utils.hostconst import host_cpu_device

        cpu = host_cpu_device()
        if cpu is not None:
            with jax.default_device(cpu):
                carry = slam_core.init_carry(config)
                key = jax.random.PRNGKey(seed)
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                dev = NamedSharding(mesh, P())  # replicated over the mesh
            else:
                dev = jax.devices()[0]  # the accelerator (cpu0 when cpu-only)
            self.carry = jax.device_put(carry, dev)
            self.key = jax.device_put(key, dev)
        else:
            self.carry = slam_core.init_carry(config)
            self.key = jax.random.PRNGKey(seed)
        self.writer = TrajectoryWriter(pose_path) if pose_path else None
        self.pending: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._backlog: Deque[list] = collections.deque()  # unuploaded chunks
        self.estimates: Dict[int, np.ndarray] = {}
        self.stats: List[dict] = []
        self.lost = False
        self._evictions: List[Tuple[int, np.ndarray]] = []
        self._pack = _make_record_packer()
        self._pool = cf.ThreadPoolExecutor(max_workers=4)  # uploads only
        self._upload_buf = threading.local()  # reused per worker thread
        self._uploads: Deque[cf.Future] = collections.deque()
        # dispatched-but-unfetched packed record arrays (device handles);
        # fetched one chunk behind on the main thread (see _pump)
        self._fetches: Deque[jnp.ndarray] = collections.deque()
        self._prefetch = max(1, prefetch)
        # how many chunks a record fetch trails the newest dispatch. Deeper
        # = the fetched chunk is certainly finished, so the blocking
        # device_get returns at once. Env-tunable to allow retuning without
        # re-keying the compiled program cache.
        import os as _os

        self._fetch_behind = max(1, int(_os.environ.get("SVS_FETCH_BEHIND", "3")))
        self.timing = collections.defaultdict(float)  # host phase breakdown
        # per-dispatch / per-fetch durations (seconds) for percentile
        # diagnosis; cleared together with `timing`
        self.dispatch_times: List[float] = []
        self.fetch_times: List[float] = []

    # ------------------------------------------------------------------
    def warmup(self):
        """Compile the chunk program + packer (cached persistently
        afterwards) on an ALL-INACTIVE chunk, which leaves the carry
        untouched in value.

        Two signature subtleties, each a full recompile inside the timed
        region when violated:
          * the warmup must take the EXACT production dispatch path (same
            upload helper, same committed carry/key arrays), or jit sees a
            different argument-sharding variant at the first real chunk;
          * the steady-state dispatch passes the PREVIOUS DISPATCH'S OUTPUT
            carry, whose on-device layouts come from the compiled
            executable and can differ from the freshly device_put init
            carry — a third signature. Dispatching twice here (second time
            on the output carry) compiles both variants up front, and
            adopting the output carry as self.carry makes every subsequent
            dispatch hit the steady-state signature."""
        buf = self._upload_job([])  # all padding slots: active=False
        carry, recs = self._packed_step(self.carry, buf, self.key)
        jax.block_until_ready(self._pack(recs))
        carry2, recs2 = self._packed_step(carry, buf, self.key)
        jax.block_until_ready(self._pack(recs2))
        self.carry = carry2

    # ------------------------------------------------------------------
    def _upload_job(self, frames):
        """Worker-thread task: assemble + device_put one chunk's buffer
        (ONE flat array, see encode_chunk_buffer).

        Assembly writes the frames straight into a REUSED per-worker flat
        buffer (allocated + zeroed once) instead of a zeros/copy/concatenate
        pass per chunk. No blocking after the put: a `block_until_ready`
        here would wait behind every queued chunk EXECUTION on the device
        stream. Each worker rotates through a small buffer ring because
        device_put may read the host buffer after it returns."""
        H, W = self.config.padded_hw
        B = self.chunk
        n_img = B * 2 * H * W
        ring = getattr(self._upload_buf, "ring", None)
        if ring is None or ring[0][0].shape[0] != n_img + 5 * B:
            ring = ([np.zeros((n_img + 5 * B,), np.uint8) for _ in range(4)],
                    [0],
                    [None] * 4,            # in-flight device array per slot
                    [np.zeros((B, 2), np.int64) for _ in range(4)])
            self._upload_buf.ring = ring
        bufs, pos, inflight, shapes = ring
        slot = pos[0] % len(bufs)
        buf = bufs[slot]
        pos[0] += 1
        # PJRT may read the host buffer AFTER device_put returns
        # (kImmutableUntilTransferCompletes); before rewriting a slot, wait
        # for the transfer issued from it 4 puts ago. In steady state that
        # transfer finished long ago, so this only blocks when the ring
        # genuinely wraps faster than the device drains uploads.
        if inflight[slot] is not None:
            inflight[slot].block_until_ready()
            inflight[slot] = None
        imgs = buf[:n_img].reshape(B, 2, H, W)
        fids = buf[n_img:n_img + 4 * B].view(np.int32)
        active = buf[n_img + 4 * B:]
        # only the valid region is rewritten; padding pixels stay zero from
        # allocation. Frames normally never shrink within a run — if one
        # does, zero that slot's full image area first so no stale pixels
        # from the previous chunk survive in its ACTIVE margin.
        active[:] = 0
        prev_hw = shapes[slot]
        for i, (fid, left, right) in enumerate(frames):
            h, w = left.shape
            if h < prev_hw[i, 0] or w < prev_hw[i, 1]:
                imgs[i] = 0
            prev_hw[i] = (h, w)
            imgs[i, 0, :h, :w] = left
            imgs[i, 1, :h, :w] = right
            fids[i] = fid
            active[i] = 1
        # padding slots reuse the last real frame id (any value works: the
        # carry passes through and the record is dropped)
        fids[len(frames):] = fids[max(len(frames) - 1, 0)]
        if jax.default_backend() == "cpu":
            # CPU device_put may alias the host numpy buffer; the reuse
            # scheme needs a private copy there (tests run on CPU)
            return jax.device_put(buf.copy())
        out = jax.device_put(buf)
        inflight[slot] = out
        return out

    # ------------------------------------------------------------------
    def process(self, frame_id: int, left: np.ndarray, right: np.ndarray):
        """Feed one frame; uploads ride background threads, throttled to
        `prefetch`+1 chunks ahead of dispatch, which bounds the host memory
        held by assembled chunks."""
        if self.lost:
            return
        self.pending.append((frame_id, left, right))
        if len(self.pending) >= self.chunk:
            self._backlog.append(self.pending[: self.chunk])
            self.pending = self.pending[self.chunk:]
        self._feed_uploads()
        self._pump()

    def _feed_uploads(self):
        while self._backlog and len(self._uploads) <= self._prefetch:
            self._uploads.append(
                self._pool.submit(self._upload_job, self._backlog.popleft())
            )

    # ------------------------------------------------------------------
    def _pump(self, drain: bool = False):
        """Dispatch ready uploads in order; fetch record batches
        `fetch_behind` CHUNKS BEHIND on the main thread.

        A device_get submitted right after its own dispatch would block the
        main thread through that chunk's whole execution; trailing several
        chunks lets the next dispatches queue first. Upload backpressure:
        never more than `prefetch` chunks assembled ahead."""
        import time as _time

        while self._uploads and (
            drain
            or self._uploads[0].done()
            or len(self._uploads) > self._prefetch
        ):
            t0 = _time.perf_counter()
            buf = self._uploads.popleft().result()
            t1 = _time.perf_counter()
            self.timing["upload_wait"] += t1 - t0
            carry, recs = self._packed_step(self.carry, buf, self.key)
            self.carry = carry
            self._fetches.append(self._pack(recs))
            t2 = _time.perf_counter()
            self.timing["dispatch"] += t2 - t1
            self.dispatch_times.append(t2 - t1)
            while len(self._fetches) > self._fetch_behind:
                self._harvest()
        while self._fetches and (drain or len(self._fetches) > self._fetch_behind):
            self._harvest()

    def _harvest(self):
        import time as _time

        t0 = _time.perf_counter()
        rows = np.asarray(jax.device_get(self._fetches.popleft()))
        dt = _time.perf_counter() - t0
        self.timing["fetch_wait"] += dt
        self.fetch_times.append(dt)
        self._consume(rows)

    # ------------------------------------------------------------------
    def _consume(self, packed: np.ndarray):
        for row in packed:
            if row[0] < 0.5:          # active
                continue
            fid = int(row[1])
            lost = row[3] > 0.5
            tracked = row[2] > 0.5
            if lost:
                self.lost = True
            rec = dict(
                frame_id=fid,
                state="lost" if lost else ("tracked" if tracked else "rejected"),
                keyframe=bool(row[4] > 0.5),
                n_matches=int(row[5]),
                n_inliers=int(row[6]),
                n_new_landmarks=int(row[7]),
                twist=float(row[8]),
                ba_cost=float(row[11]) if row[10] > 0.5 else None,
            )
            self.stats.append(rec)
            if tracked:
                self.estimates[fid] = row[14:30].reshape(4, 4).copy()
            if row[12] > 0.5:         # evict_valid
                efid = int(row[13])
                eT = row[30:46].reshape(4, 4).copy()
                self._evictions.append((efid, eT))
                self.estimates[efid] = eT
                if self.writer is not None:
                    self.writer.write(efid, eT)

    # ------------------------------------------------------------------
    def run(self, frames, stage: bool = True):
        """Batch-process a pre-rendered sequence: (frame_id, left, right)
        triples, in order. With `stage=True` every chunk buffer is uploaded
        to the device BEFORE the dispatch loop starts — the offline/dataset
        processing mode, equivalent to the native prefetching loader
        (native/src/slamio.cpp) filling device memory ahead of compute.
        Results are identical either way; only the upload schedule moves.
        """
        if not stage:
            for f, left, right in frames:
                self.process(f, left, right)
                if self.lost:
                    break
            self.flush()
            return
        self.run_staged(self.stage(frames))

    def stage(self, frames):
        """Upload a pre-rendered sequence's chunk buffers to device memory
        (blocking per put, so the host buffer ring reuse is safe). The
        returned list feeds run_staged — and can be replayed any number of
        times (buffers are read-only inputs)."""
        bufs = []
        for i in range(0, len(frames), self.chunk):
            b = self._upload_job(frames[i:i + self.chunk])
            b.block_until_ready()
            bufs.append(b)
        return bufs

    def run_staged(self, bufs):
        """Dispatch + harvest a staged buffer list (see run/stage)."""
        for buf in bufs:
            if self.lost:
                break
            self._fetches.append(
                self._pack(self._dispatch(buf))
            )
            while len(self._fetches) > self._fetch_behind:
                self._harvest()
        while self._fetches:
            self._harvest()

    def run_rolling(self, frames, window_chunks: int = 8, on_progress=None):
        """Bounded stage-ahead processing: at most `window_chunks` chunk
        buffers live in device memory ahead of dispatch — the dataset mode
        for sequences too long to stage whole (`run(stage=True)` uploads
        ALL buffers first: 4.4 GB of HBM for the reference's 4,541-frame
        seq 00). Uploads run on the pool in REFILL BURSTS that alternate
        with dispatch/fetch bursts; this bounds device and host memory.

        `frames` may be any iterable of (frame_id, left, right) — a lazy
        dataset source (e.g. the native prefetching loader behind
        kitti.Sequence.frames()) is pulled only `window_chunks` chunks
        ahead, so host memory is bounded too. `on_progress()` is called
        after each dispatch burst (driver reporting / live viz hook).

        Results are bit-identical to run()/run_staged() on the same frames
        (same chunking, same carry sequence).
        """
        import itertools

        it = iter(frames)
        staged: Deque[cf.Future] = collections.deque()
        exhausted = False
        low_water = max(1, window_chunks // 2)
        while (not exhausted or staged) and not self.lost:
            # refill burst: queue uploads until the window is full
            while not exhausted and len(staged) < window_chunks:
                chunk = list(itertools.islice(it, self.chunk))
                if not chunk:
                    exhausted = True
                    break
                staged.append(self._pool.submit(self._upload_job, chunk))
            # dispatch burst: drain to the low-water mark (or dry)
            while staged and not self.lost and (
                len(staged) > low_water or exhausted
            ):
                buf = staged.popleft().result()
                self._fetches.append(self._pack(self._dispatch(buf)))
                while len(self._fetches) > self._fetch_behind:
                    self._harvest()
            if on_progress is not None:
                on_progress()
        while staged:      # lost mid-run: drain remaining upload futures
            staged.popleft().result()
        while self._fetches:
            self._harvest()

    def _dispatch(self, buf):
        import time as _time

        t1 = _time.perf_counter()
        carry, recs = self._packed_step(self.carry, buf, self.key)
        self.carry = carry
        t2 = _time.perf_counter()
        self.timing["dispatch"] += t2 - t1
        self.dispatch_times.append(t2 - t1)
        return recs

    # ------------------------------------------------------------------
    def flush(self):
        """Dispatch any buffered partial chunk and drain every in-flight
        upload/fetch, leaving the carry current through the last fed frame."""
        if self.pending and not self.lost:
            self._backlog.append(self.pending)
            self.pending = []
        while self._backlog and not self.lost:
            # stop dispatching once a harvested record reports Lost, matching
            # run_staged's early break — otherwise streaming mode records
            # more post-lost frames than staged mode on lost sequences
            self._feed_uploads()
            self._pump(drain=True)
        if self.lost:
            self._backlog.clear()
            while self._uploads:       # discard undispatched uploads
                self._uploads.popleft().result()
        self._pump(drain=True)

    # ------------------------------------------------------------------
    def close(self):
        """Drain in-flight work and stop the transfer worker threads. The
        instance stays usable read-only (carry, estimates, stats); feeding
        more frames after close() is an error."""
        self.flush()
        self._pool.shutdown(wait=True)

    def finish(self):
        """Flush, write the remaining window poses
        (write_remaining_pose, map.cpp:198-204), and release the transfer
        thread pool."""
        self.flush()
        kf_ids, kf_T, count = jax.device_get(
            (
                self.carry.mstate.kf_frame_id,
                self.carry.mstate.kf_T,
                self.carry.mstate.kf_count,
            )
        )
        order = np.argsort(kf_ids[: int(count)])
        for j in order:
            fid = int(kf_ids[j])
            if fid < 0:
                continue
            self.estimates[fid] = np.asarray(kf_T[j])
            if self.writer is not None:
                self.writer.write(fid, kf_T[j])
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def landmarks(self) -> np.ndarray:
        """(M, 3) world positions of the live landmark arena rows — the
        device analog of MapStore's landmark cloud (used by --ply/--plot)."""
        m = jax.device_get(self.carry.mstate)
        live = (m.obs_mask.max(axis=1) > 0) & m.inlier
        return np.asarray(m.pos[live])

    @property
    def map(self) -> "_MapView":
        """Duck-typed MapStore view over the device map, so pipeline/viz
        (plot_trajectory, export_landmarks_ply) works unchanged."""
        return _MapView(jax.device_get(self.carry.mstate))

    # ------------------------------------------------------------------
    def save_snapshot(self, path: str):
        """Serialize the device carry + host counters. Drains the pipeline
        first (the partial chunk dispatches with inactive padding, so no
        recompile and no semantic difference vs an uninterrupted run)."""
        self.flush()
        carry = jax.device_get(self.carry)
        data = {"chunked_version": np.int64(1), "lost": np.bool_(self.lost)}
        data["key"] = np.asarray(jax.device_get(self.key))
        for part in ("tstate", "mstate"):
            sub = getattr(carry, part)
            for name, arr in sub._asdict().items():
                data[f"{part}_{name}"] = np.asarray(arr)
        for name in ("last_frame_id", "num_lost"):
            data[f"carry_{name}"] = np.asarray(getattr(carry, name))
        data["carry_lost"] = np.asarray(carry.lost)
        np.savez_compressed(path, **data)

    # ------------------------------------------------------------------
    def load_snapshot(self, path: str):
        """Restore a carry saved by save_snapshot (same Config required)."""
        from stereo_visual_slam.models import vslam

        z = np.load(path, allow_pickle=False)
        assert int(z["chunked_version"]) == 1
        tstate = vslam.TrackState(
            **{n: jnp.asarray(z[f"tstate_{n}"]) for n in vslam.TrackState._fields}
        )
        mstate = slam_core.MapState(
            **{n: jnp.asarray(z[f"mstate_{n}"])
               for n in slam_core.MapState._fields}
        )
        self.carry = slam_core.SlamCarry(
            tstate=tstate,
            mstate=mstate,
            last_frame_id=jnp.asarray(z["carry_last_frame_id"]),
            num_lost=jnp.asarray(z["carry_num_lost"]),
            lost=jnp.asarray(z["carry_lost"]),
        )
        self.key = jnp.asarray(z["key"])
        self.lost = bool(z["lost"])
