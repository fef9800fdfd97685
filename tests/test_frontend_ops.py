import jax.numpy as jnp
import numpy as np
import pytest

from stereo_visual_slam.ops import anms as anms_ops
from stereo_visual_slam.ops import fast as fast_ops
from stereo_visual_slam.ops import image as im_ops
from stereo_visual_slam.ops import matcher as match_ops
from stereo_visual_slam.ops import orb as orb_ops
from stereo_visual_slam.ops import stereo as stereo_ops


def blob_image(h=96, w=128, centers=((30, 40), (60, 90), (48, 64)), seed=0):
    """Dark background with small bright squares (strong FAST corners)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(10, 25, (h, w)).astype(np.float32)
    for (y, x) in centers:
        img[y - 2 : y + 3, x - 2 : x + 3] = rng.uniform(180, 255, (5, 5))
    return jnp.asarray(img)


# ---------------- FAST ----------------

def test_pruned_topk_matches_full():
    """nms_topk == a NumPy stable sort over the 2x2-pooled map:
    same scores, same index tie-breaking — on sparse maps (the real regime),
    tie-heavy maps, near-empty maps (fewer than k positives), and a dense
    map."""
    import jax

    rng = np.random.default_rng(7)
    H, W = 128, 512          # pooled map: 16384 cells
    k = 200

    def reference(score):
        H2, W2 = H // 2, W // 2
        s4 = score.reshape(H2, 2, W2, 2)
        pooled = s4.max(axis=(1, 3))
        off = np.where(
            s4[:, 0, :, 0] == pooled, 0,
            np.where(s4[:, 0, :, 1] == pooled, 1,
                     np.where(s4[:, 1, :, 0] == pooled, 2, 3)))
        flat = pooled.reshape(-1)
        top_idx = np.argsort(-flat, kind="stable")[:k]
        y = 2 * (top_idx // W2) + off.reshape(-1)[top_idx] // 2
        x = 2 * (top_idx % W2) + (off.reshape(-1)[top_idx] & 1)
        return flat[top_idx], np.stack([y, x], -1)

    def sparse_map(n, tie_value=None):
        score = np.zeros((H, W), np.float32)
        ys = rng.choice(H // 2, size=n) * 2
        xs = rng.choice(W // 2, size=n) * 2
        vals = (tie_value if tie_value is not None
                else rng.uniform(1, 200, size=n))
        score[ys, xs] = vals
        return score

    for name, score in (
        ("sparse", sparse_map(600)),
        ("ties", sparse_map(600, tie_value=42.0)),
        ("near-empty", sparse_map(k // 4)),
        ("empty", np.zeros((H, W), np.float32)),
    ):
        ts, yx = fast_ops.nms_topk(jnp.asarray(score), k)
        ref_s, ref_yx = reference(score)
        np.testing.assert_array_equal(np.asarray(ts), ref_s, err_msg=name)
        live = ref_s > 0
        np.testing.assert_array_equal(
            np.asarray(yx)[live], ref_yx[live], err_msg=name
        )

    # dense map: every pooled cell nonzero -> same as full top_k
    dense = rng.uniform(1, 10, (H, W)).astype(np.float32)
    ts, yx = fast_ops.nms_topk(jnp.asarray(dense), k)
    ts_full, idx_full = jax.lax.top_k(
        jnp.asarray(dense.reshape(H // 2, 2, W // 2, 2).max(axis=(1, 3))
                    .reshape(-1)), k)
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(ts_full))

    # batched (B, H, W) agrees with per-image calls
    batch = np.stack([sparse_map(500), sparse_map(300)], 0)
    ts_b, yx_b = fast_ops.nms_topk(jnp.asarray(batch), k)
    for i in range(2):
        ts_i, yx_i = fast_ops.nms_topk(jnp.asarray(batch[i]), k)
        np.testing.assert_array_equal(np.asarray(ts_b[i]), np.asarray(ts_i))
        np.testing.assert_array_equal(np.asarray(yx_b[i]), np.asarray(yx_i))


def test_fast_detects_blobs():
    centers = [(30, 40), (60, 90), (48, 64)]
    img = blob_image(centers=centers)
    yx, score = fast_ops.detect(img, max_kp=32, threshold=20.0, border=8)
    found = np.asarray(yx[score > 0])
    assert len(found) >= len(centers)
    for (cy, cx) in centers:
        d = np.abs(found - np.array([cy, cx])).sum(axis=1).min()
        assert d <= 4, f"blob at {(cy, cx)} not detected (nearest {d})"


def test_fast_rejects_flat_and_edge():
    img = jnp.zeros((64, 64)) + 50.0
    # vertical step edge — FAST must NOT fire on a pure long edge interior
    img = img.at[:, 32:].set(200.0)
    yx, score = fast_ops.detect(img, max_kp=16, threshold=20.0, border=8)
    # few or no detections on an infinite edge (ends are outside border)
    assert int(jnp.sum(score > 0)) == 0


def test_fast_score_positive_at_corner():
    img = blob_image()
    score_map = fast_ops.fast_score_map(img, 20.0)
    assert float(score_map[30, 40]) > 0 or float(score_map[29, 40]) > 0


# ---------------- ANMS ----------------

def test_anms_uniform_selection():
    # grid of keypoints with random scores; ANMS should pick a spread subset
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[10:90:10, 10:120:10]
    pts = np.stack([ys.ravel(), xs.ravel()], axis=-1)
    scores = rng.uniform(1, 100, len(pts)).astype(np.float32)
    yx, s, rad = anms_ops.anms(
        jnp.asarray(pts, jnp.int32), jnp.asarray(scores), num=20
    )
    sel = np.asarray(yx[s > 0])
    assert len(sel) == 20
    # min pairwise distance of selection should beat a random subset's
    def min_pdist(p):
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min()

    rand_sel = pts[rng.choice(len(pts), 20, replace=False)]
    assert min_pdist(sel) >= min_pdist(rand_sel) * 0.8


def test_anms_strongest_kept():
    pts = np.array([[10, 10], [10, 12], [50, 50]], dtype=np.int32)
    scores = np.array([100.0, 10.0, 50.0], dtype=np.float32)
    yx, s, rad = anms_ops.anms(jnp.asarray(pts), jnp.asarray(scores), num=2)
    sel = {tuple(p) for p in np.asarray(yx[s > 0])}
    assert (10, 10) in sel and (50, 50) in sel


# ---------------- ORB descriptors ----------------

def test_descriptor_deterministic_and_packed():
    img = im_ops.box_blur(blob_image(), 5)
    yx = jnp.asarray([[30, 40], [60, 90]], jnp.int32)
    packed, signs, theta = orb_ops.describe(img, yx)
    packed2, signs2, _ = orb_ops.describe(img, yx)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(packed2))
    assert packed.shape == (2, 8) and signs.shape == (2, 256)
    assert set(np.unique(np.asarray(signs))) <= {-1.0, 1.0}


def test_descriptor_translation_invariant():
    """Same pattern at two locations -> near-identical descriptors."""
    rng = np.random.default_rng(3)
    patch = rng.uniform(0, 255, (21, 21)).astype(np.float32)
    img = np.full((128, 128), 20.0, np.float32)
    img[30 - 10 : 30 + 11, 30 - 10 : 30 + 11] = patch
    img[80 - 10 : 80 + 11, 90 - 10 : 90 + 11] = patch
    imgb = im_ops.box_blur(jnp.asarray(img), 5)
    _, signs, _ = orb_ops.describe(imgb, jnp.asarray([[30, 30], [80, 90]], jnp.int32))
    ham = float(orb_ops.hamming_from_signs(signs[:1], signs[1:])[0, 0])
    assert ham <= 20, f"hamming {ham} too large for identical patches"


def test_descriptor_distinct_patterns():
    rng = np.random.default_rng(4)
    img = np.full((128, 128), 20.0, np.float32)
    img[30 - 10 : 30 + 11, 30 - 10 : 30 + 11] = rng.uniform(0, 255, (21, 21))
    img[80 - 10 : 80 + 11, 90 - 10 : 90 + 11] = rng.uniform(0, 255, (21, 21))
    imgb = im_ops.box_blur(jnp.asarray(img), 5)
    _, signs, _ = orb_ops.describe(imgb, jnp.asarray([[30, 30], [80, 90]], jnp.int32))
    ham = float(orb_ops.hamming_from_signs(signs[:1], signs[1:])[0, 0])
    assert ham >= 60, f"hamming {ham} too small for distinct patches"


def test_hamming_matches_popcount():
    rng = np.random.default_rng(5)
    bits_a = rng.integers(0, 2, (16, 256)).astype(bool)
    bits_b = rng.integers(0, 2, (24, 256)).astype(bool)
    signs_a = jnp.where(jnp.asarray(bits_a), 1.0, -1.0)
    signs_b = jnp.where(jnp.asarray(bits_b), 1.0, -1.0)
    d = np.asarray(orb_ops.hamming_from_signs(signs_a, signs_b))
    expected = (bits_a[:, None, :] != bits_b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(d.astype(int), expected)


# ---------------- Matcher ----------------

def test_matcher_crosscheck_and_gate():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (8, 256)).astype(bool)
    # curr = permuted last with small noise; add one unmatched distractor
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    bits_curr = bits[perm].copy()
    flip = rng.integers(0, 256, (8, 6))
    for i in range(8):
        bits_curr[i, flip[i]] ^= True
    sa = jnp.where(jnp.asarray(bits), 1.0, -1.0)
    sb = jnp.where(jnp.asarray(bits_curr), 1.0, -1.0)
    res = match_ops.match(
        sa, jnp.ones(8, bool), sb, jnp.ones(8, bool), jnp.asarray(1.0)
    )
    m = np.asarray(res.mask)
    assert m.sum() == 8
    got = np.asarray(res.idx_curr)
    for i in range(8):
        # last i should match the slot where it went: perm[j] = i -> j
        assert got[perm[i]] == ...  if False else True
    # correct assignment: idx_curr[last] should satisfy bits_curr[idx] ~ bits[last]
    for i in range(8):
        assert perm[got[i]] == i


def test_matcher_masks_invalid():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (4, 256)).astype(bool)
    sa = jnp.where(jnp.asarray(bits), 1.0, -1.0)
    valid_last = jnp.asarray([True, True, False, False])
    res = match_ops.match(sa, valid_last, sa, jnp.ones(4, bool), jnp.asarray(1.0))
    m = np.asarray(res.mask)
    assert not m[2] and not m[3]
    assert m[0] and m[1]


# ---------------- Stereo ----------------

def test_stereo_known_disparity():
    rng = np.random.default_rng(8)
    h, w = 96, 256
    disp_true = 17
    right = rng.uniform(0, 255, (h, w)).astype(np.float32)
    left = np.roll(right, disp_true, axis=1)  # left shifted right by disp
    yx = jnp.asarray([[40, 120], [60, 200], [20, 80]], jnp.int32)
    res = stereo_ops.match_disparity(
        jnp.asarray(left),
        jnp.asarray(right),
        yx,
        jnp.ones(3, bool),
        fx=718.856,
        baseline=0.573,
        max_disparity=32,
        min_depth=1.0,
        max_depth=1000.0,
    )
    d = np.asarray(res.disparity)
    assert np.all(np.abs(d - disp_true) < 0.5), d
    assert np.all(np.asarray(res.valid))
    z = np.asarray(res.depth)
    np.testing.assert_allclose(z, 718.856 * 0.573 / d, rtol=1e-5)


def test_stereo_depth_gates():
    rng = np.random.default_rng(9)
    h, w = 64, 128
    disp_true = 2  # depth = 718.856*0.573/2 = 206m -> beyond 150 gate
    right = rng.uniform(0, 255, (h, w)).astype(np.float32)
    left = np.roll(right, disp_true, axis=1)
    yx = jnp.asarray([[32, 64]], jnp.int32)
    res = stereo_ops.match_disparity(
        jnp.asarray(left), jnp.asarray(right), yx, jnp.ones(1, bool),
        fx=718.856, baseline=0.573, max_disparity=32,
        min_depth=10.0, max_depth=150.0,
    )
    assert not bool(res.valid[0])


def test_backproject():
    yx = jnp.asarray([[185, 607]], jnp.int32)  # ~principal point
    pts = stereo_ops.backproject(
        yx, jnp.asarray([50.0]), fx=718.856, fy=718.856, cx=607.1928, cy=185.2157
    )
    p = np.asarray(pts[0])
    assert abs(p[0]) < 0.1 and abs(p[1]) < 0.1 and abs(p[2] - 50.0) < 1e-4
