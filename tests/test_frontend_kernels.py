"""The frontend's kernels and their plain references, on the CPU.

FAST (XLA formulation and the Triton kernel in interpret mode) against a
NumPy brute-force FAST-9, the ZNCC sweep against a NumPy brute-force ZNCC,
the patch gather against NumPy slicing, and the small pieces around them:
the platform choice of the FAST path, the device peak table, the compile
cache directory, and the GPU checks of chip_smoke.py and bench.py. The one
`gpu` test compiles the Triton kernel for the card and skips elsewhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_visual_slam.ops import fast as fast_ops
from stereo_visual_slam.ops import image as im_ops
from stereo_visual_slam.ops import orb as orb_ops
from stereo_visual_slam.ops import stereo as stereo_ops
from stereo_visual_slam.ops.pallas import fast_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# FAST-9/16
def fast9_bruteforce(img: np.ndarray, t: float) -> np.ndarray:
    """Score = max over the 16 arcs of 9 contiguous circle pixels that are
    all brighter than I_p + t (or all darker than I_p - t) of the arc's
    weakest |I_j - I_p|; zero outside the image."""
    H, W = img.shape
    pad = np.pad(img, 3)
    score = np.zeros_like(img)
    for y in range(H):
        for x in range(W):
            c = img[y, x]
            d = np.array([pad[y + 3 + dy, x + 3 + dx] - c
                          for dy, dx in fast_ops.CIRCLE_OFFSETS])
            best = 0.0
            for k in range(16):
                arc = d[[(k + i) % 16 for i in range(9)]]
                if (arc > t).all():
                    best = max(best, arc.min())
                if (-arc > t).all():
                    best = max(best, (-arc).min())
            score[y, x] = best
    return score


def nms_bruteforce(score: np.ndarray) -> np.ndarray:
    """3x3 NMS; ties go to the earlier pixel in raster order."""
    H, W = score.shape
    out = np.zeros_like(score)
    for y in range(H):
        for x in range(W):
            keep = True
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy, xx = y + dy, x + dx
                    if (dy, dx) == (0, 0) or not (0 <= yy < H and 0 <= xx < W):
                        continue
                    later = dy > 0 or (dy == 0 and dx > 0)
                    n = score[yy, xx]
                    keep &= score[y, x] >= n if later else score[y, x] > n
            out[y, x] = score[y, x] if keep else 0.0
    return out


def _image(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    H, W = 40, 70  # not multiples of the kernel blocks: exercises padding
    img = rng.uniform(10, 30, (H, W)).astype(np.float32)
    if kind == "block_edges":
        # bright squares centred on and next to kernel block boundaries
        for y, x in [(15, 63), (16, 64), (8, 31), (31, 32), (3, 3), (36, 66)]:
            img[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = 220.0
    elif kind == "dark_corners":
        img += 150.0
        for y, x in [(10, 10), (20, 40), (30, 60), (16, 16)]:
            img[y - 2:y + 3, x - 2:x + 3] = 5.0
    elif kind == "integer_texture":
        img = rng.integers(0, 256, (H, W)).astype(np.float32)
    return img


@pytest.mark.parametrize("kind", ["block_edges", "dark_corners",
                                  "integer_texture"])
def test_fast_xla_matches_bruteforce(kind):
    img = _image(kind)
    ref = nms_bruteforce(fast9_bruteforce(img, 20.0))
    got = fast_ops.nms_3x3(fast_ops.fast_score_map(jnp.asarray(img), 20.0))
    assert (ref > 0).sum() > 0
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("block,num_warps", [((16, 64), 4), ((8, 128), 4),
                                             ((32, 32), 8)])
def test_fast_kernel_interpret_matches_xla(block, num_warps):
    """The Triton kernel (interpret mode) equals ops/fast bit for bit,
    including corners on block boundaries and a padded last block."""
    img = jnp.asarray(_image("block_edges"))
    ref = fast_ops.fast_score_map(img, 20.0)
    got = fast_kernel.fast_score_map(
        img, 20.0, block=block, num_warps=num_warps, interpret=True
    )
    assert got.shape == img.shape
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_frontend_fast_path_is_the_kernel_only_on_gpu():
    """The frontend's FAST score map lowers to the Triton kernel for CUDA
    and to plain XLA for the CPU."""
    from stereo_visual_slam.models import frontend

    x = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    fn = jax.jit(lambda im: frontend._fast_nms(im, 20))
    cuda = fn.trace(x).lower(lowering_platforms=("cuda",)).as_text()
    cpu = fn.trace(x).lower(lowering_platforms=("cpu",)).as_text()
    assert "fast_score_map" in cuda and "triton" in cuda.lower()
    assert "triton" not in cpu.lower()


@pytest.mark.gpu
def test_fast_kernel_compiled_on_gpu_matches_xla():
    """Run on the card with: JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/"""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU path")
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (8 * 384, 1280)), jnp.float32)
    got = jax.jit(lambda im: fast_kernel.fast_score_map(im, 20))(img)
    ref = jax.jit(lambda im: fast_ops.fast_score_map(im, 20))(img)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# stereo
def zncc_bruteforce(left, right, yx, p, D):
    """(N, D) ZNCC of the p x p left patch at each keypoint against the
    right patch shifted left by d, zero padding outside the image."""
    r = p // 2
    H, W = left.shape
    lp = np.pad(left, r)
    rp = np.pad(right, ((r, r), (D + r, r)))
    out = np.zeros((len(yx), D), np.float32)
    for n, (y, x) in enumerate(yx):
        y = min(max(y, 0), H - 1)
        x = min(max(x, 0), W - 1)
        a = lp[y:y + p, x:x + p].astype(np.float64)
        a = a - a.mean()
        a = a / (np.sqrt((a * a).sum()) + 1e-6)
        for d in range(D):
            c0 = x - d + D  # column of the window's left edge in rp
            b = rp[y:y + p, c0:c0 + p].astype(np.float64)
            b = b - b.mean()
            b = b / (np.sqrt((b * b).sum()) + 1e-6)
            out[n, d] = (a * b).sum()
    return out


@pytest.fixture(scope="module")
def shifted_pair():
    """Random texture with the right image 17 px left of the left one."""
    rng = np.random.default_rng(2)
    left = rng.uniform(0, 255, (48, 160)).astype(np.float32)
    return left, np.roll(left, -17, axis=1)


@pytest.mark.parametrize("where", ["interior", "border"])
def test_zncc_sweep_matches_bruteforce(shifted_pair, where):
    left, right = shifted_pair
    H, W = left.shape
    if where == "interior":
        rng = np.random.default_rng(3)
        yx = np.stack([rng.integers(8, H - 8, 12),
                       rng.integers(40, W - 20, 12)], -1)
    else:
        yx = np.array([[0, 0], [0, W - 1], [H - 1, 0], [H - 1, W - 1],
                       [2, 5], [H - 3, W - 4], [24, 1], [1, 80]])
    yx = yx.astype(np.int32)
    got = stereo_ops.zncc_sweep_xla(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(yx),
        patch=11, max_disparity=24,
    )
    ref = zncc_bruteforce(left, right, yx, 11, 24)
    np.testing.assert_allclose(np.asarray(got), ref, atol=2e-5)


def test_match_disparity_recovers_known_shift(shifted_pair):
    left, right = shifted_pair
    rng = np.random.default_rng(4)
    yx = np.stack([rng.integers(8, 40, 16), rng.integers(40, 140, 16)], -1)
    st = stereo_ops.match_disparity(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(yx, jnp.int32),
        jnp.ones((16,), bool), fx=718.856, baseline=0.573,
        max_disparity=32, patch=11,
    )
    np.testing.assert_allclose(np.asarray(st.disparity), 17.0, atol=0.05)
    assert np.asarray(st.valid).all() and np.asarray(st.reliable).all()
    np.testing.assert_allclose(
        np.asarray(st.depth), 718.856 * 0.573 / 17.0, rtol=5e-3
    )


# ---------------------------------------------------------------------------
# patch gather
def _patches_numpy(img, yx, P):
    H, W = img.shape
    r = P // 2
    out = []
    for y, x in yx:
        y0 = min(max(y - r, 0), H - P)
        x0 = min(max(x - r, 0), W - P)
        out.append(img[y0:y0 + P, x0:x0 + P])
    return np.stack(out)


def test_gather_patches_matches_numpy_with_clamped_corners():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    yx = np.concatenate([
        np.stack([rng.integers(0, 64, 17), rng.integers(0, 96, 17)], -1),
        np.array([[0, 0], [63, 95], [5, 90], [60, 3], [-4, 200]]),
    ]).astype(np.int32)
    got = im_ops.gather_patches(jnp.asarray(img), jnp.asarray(yx), 33)
    np.testing.assert_array_equal(np.asarray(got), _patches_numpy(img, yx, 33))


def test_batched_gather_clamps_within_each_frame():
    """The batch extractor gathers per frame (vmap), so patches at a
    frame's top or bottom rows clamp inside that frame."""
    rng = np.random.default_rng(4)
    B, H, W = 3, 40, 64
    frames = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    yx = np.stack([rng.integers(0, H, (B, 8)), rng.integers(0, W, (B, 8))],
                  -1).astype(np.int32)
    yx[:, :4, 0] = [0, 1, H - 1, H - 2]
    got = jax.vmap(lambda im, c: im_ops.gather_patches(im, c, 33))(
        jnp.asarray(frames), jnp.asarray(yx)
    )
    for b in range(B):
        np.testing.assert_array_equal(
            np.asarray(got[b]), _patches_numpy(frames[b], yx[b], 33)
        )


@pytest.mark.parametrize("steer", [False, True])
def test_describe_patches_equals_describe(steer):
    """The split describe (gather + describe_patches) is bit-identical to
    the fused describe."""
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.integers(0, 256, (128, 256)).astype(np.float32))
    yx = jnp.asarray(np.stack(
        [rng.integers(0, 128, 16), rng.integers(0, 256, 16)], -1
    ).astype(np.int32))
    ref = orb_ops.describe(img, yx, bits=256, patch=33, steer=steer)
    got = orb_ops.describe_patches(
        im_ops.gather_patches(img, yx, 33), bits=256, steer=steer
    )
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# peak table, compile cache, GPU checks
def test_roofline_knows_the_h100():
    from stereo_visual_slam.utils import roofline

    p = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    assert (p.bf16_flops, p.tf32_flops, p.fp32_flops) == (989e12, 495e12, 67e12)
    assert p.hbm_bytes == 3.35e12 and p.power_w == 700.0


@pytest.mark.parametrize("power_w, shares", [(700.0, True), (400.0, False)])
def test_roofline_shares_only_at_the_peaks_power(power_w, shares):
    from stereo_visual_slam.utils import roofline

    cost = roofline.ProgramCost(flops=989e9, bytes_accessed=3.35e9)
    line = roofline.summarize(
        "x", cost, 1e-3, power_w, roofline.device_peaks("NVIDIA H100 80GB HBM3")
    )
    assert ("100.00% MFU / 100.0% memory bw" in line) == shares
    assert ("no MFU or bandwidth share" in line) == (not shares)


def test_roofline_unknown_device_is_an_error():
    from stereo_visual_slam.utils import roofline

    with pytest.raises(KeyError, match="no published peaks"):
        roofline.device_peaks("Some Accelerator 9000")
    with pytest.raises(KeyError):
        roofline.device_peaks()  # the CPU backend has no peaks


@pytest.fixture
def cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir(monkeypatch, tmp_path, cache_config, env_set):
    from stereo_visual_slam.utils import cache

    jax.config.update("jax_compilation_cache_dir", None)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # set no other
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = cache.enable_compilation_cache()
        assert d == cache.DEFAULT_DIR and d.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke

        yield chip_smoke
    finally:
        sys.path.remove(ROOT)


def test_chip_smoke_refuses_cpu(chip_smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_prints_no_result_without_gpu(chip_smoke, capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(monkeypatch):
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
