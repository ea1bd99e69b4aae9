"""PyTorch port vs the JAX package: normalization, ridge head, image I/O and
the age/race/gender heads, up to ``detect`` with attributes.

Both sides run on the CPU on the same numpy inputs. Tolerances:

- ``frame_params``, ``_tta_offsets``, ``_age_patch_zgrid``: host numpy,
  copied operation for operation: exact;
- bilinear samplers: float32 sums in the same order, but XLA may fuse a
  multiply-add. ``sample_frame`` and ``_sample_age_patches``: 1e-5 on
  [0, 1] pixels. ``extract_centered_patch`` and ``extract_patches_rotate``
  (bilinear) build their source positions from more float32 terms, at
  coordinates up to 256 px, whose float32 spacing is 3e-5; a bilinear
  weight, and with it a pixel, moves by that much: 5e-5 (measured: up to
  1.6e-5);
- heads on the shipped artifacts: the f32 products of the two frameworks
  differ by ~1e-5 relative and the Gaussian soft regression amplifies that:
  age and its std (years, 16..58) within 2e-3, race (-2..2) and gender
  (-1..1) within 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_detector import random_artifact_dir  # noqa: F401  (fixture)
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch import normalization as t_norm
from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.engine import heads as t_heads
from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.io import images as t_images
from pyfaceanalysis_torch.ops.patches import (
    extract_centered_patch as t_centered,
    extract_patches_rotate as t_extract,
)
from pyfaceanalysis_torch.ops.ridge import RidgeRegressor as TRidge
from pyfaceanalysis_tpu import normalization as j_norm
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.engine import detector as j_detector
from pyfaceanalysis_tpu.engine import heads as j_heads
from pyfaceanalysis_tpu.io import artifacts as j_art
from pyfaceanalysis_tpu.ops.patches import (
    extract_centered_patch as j_centered,
    extract_patches_rotate as j_extract,
)
from pyfaceanalysis_tpu.ops.ridge import RidgeRegressor as JRidge
from pyfaceanalysis_tpu.training import datasets as j_datasets
from pyfaceanalysis_tpu.training import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "SavedNetworksTPU")
PIXEL_TOL = dict(rtol=0, atol=1e-5)
BOX_PIXEL_TOL = dict(rtol=0, atol=5e-5)

_ROWS = np.array([
    [20.0, 20.0, 84.0, 84.0, 0.0, 38.0, 44.0, 66.0, 44.0, 0.9],
    [10.0, 15.0, 74.0, 79.0, 5.0, 28.0, 40.0, 55.0, 38.0, 0.8],
    [60.0, 30.0, 130.0, 100.0, -7.0, 82.0, 58.0, 112.0, 63.0, 0.5],
])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _scene(seed=3, hw=(200, 240)):
    img, _ = synth.render_face(jax.random.PRNGKey(seed), canvas_hw=hw,
                               face_size=70.0, angle_deg=8.0)
    return np.asarray(img, np.float32)


@pytest.fixture(scope="module")
def shipped_models():
    return (j_detector.DetectionModel.load(ART),
            t_detector.DetectionModel.load(ART, device="cpu"))


def test_age_patch_constants_match_jax():
    assert t_heads.Z_SIZE == j_datasets.Z_SIZE
    assert t_heads.AGE_SAMPLING == j_datasets.AGE_SAMPLING
    assert t_heads.AGE_TY == j_datasets.AGE_TY
    assert t_heads.age_patch_constants() == j_datasets.age_patch_constants()
    assert t_norm.DESIRED_AREA == j_norm.DESIRED_AREA


@pytest.mark.parametrize("method", [
    "eyes_mouth_area", "eyes_inferred-mouth_area",
    "eyes_inferred-mouth_areaZ", "eyes_inferred-mouth_areaZ-Test"])
@pytest.mark.parametrize("centering,rotation", [
    ("mid_eyes_mouth", "noRotation"),
    ("mid_eyes_inferred-mouth", "EyeLineRotation"),
    ("eyeL", "EyeLineRotation"), ("eyeR", "noRotation"),
    ("noFace", "EyeLineRotation")])
def test_frame_params_exact(method, centering, rotation):
    """Host float64 numpy on both sides: every field equal (atol 0)."""
    coords = (101.25, 88.5, 139.75, 93.0, 118.0, 131.5)
    kw = dict(normalization_method=method, centering_mode=centering,
              rotation_mode=rotation, out_size=(256, 260))
    want = j_norm.frame_params(coords, rng=np.random.RandomState(5), **kw)
    got = t_norm.frame_params(coords, rng=np.random.RandomState(5), **kw)
    assert (got.center_x, got.center_y, got.angle_deg, got.sf, got.mirror) \
        == (want.center_x, want.center_y, want.angle_deg, want.sf,
            want.mirror)


def test_frame_params_rejects_unknown_modes():
    with pytest.raises(ValueError, match="normalization"):
        t_norm.frame_params((0, 0, 10, 0, 5, 9), normalization_method="x")
    with pytest.raises(ValueError, match="centering"):
        t_norm.frame_params((0, 0, 10, 0, 5, 9), centering_mode="x")


@pytest.mark.parametrize("centering", ["mid_eyes_mouth", "eyeR"])
def test_sample_frame_matches_jax(centering):
    """Zero background (and the mirrored eyeR frame): within 1e-5."""
    img = np.random.RandomState(1).rand(90, 110).astype(np.float32)
    coords = (40.0, 38.0, 66.0, 42.0, 52.0, 70.0)
    fp = j_norm.frame_params(coords, centering_mode=centering,
                             rotation_mode="EyeLineRotation",
                             out_size=(192, 144))
    want = np.asarray(j_norm.sample_frame(jnp.asarray(img), fp, (192, 144)))
    got = t_norm.sample_frame(_t(img), t_norm.FrameParams(
        fp.center_x, fp.center_y, fp.angle_deg, fp.sf, fp.mirror),
        (192, 144))
    assert got.shape == (144, 192)
    np.testing.assert_allclose(got.numpy(), want, **PIXEL_TOL)
    assert (want == 0).any() and (want != 0).any()   # frame leaves the image


def test_sample_frame_random_background():
    """The noise itself cannot equal JAX's (another generator): the
    out-of-frame mask is where the two backgrounds differ from the zero
    background, and in-frame pixels keep the zero-background values."""
    img = 0.25 + 0.5 * np.random.RandomState(2).rand(60, 70).astype(
        np.float32)
    fp = t_norm.FrameParams(30.0, 28.0, 12.0, 1.6)
    zero = t_norm.sample_frame(_t(img), fp, (64, 48)).numpy()
    g = torch.Generator().manual_seed(7)
    rnd = t_norm.sample_frame(_t(img), fp, (64, 48), background="random",
                              generator=g).numpy()
    jrnd = np.asarray(j_norm.sample_frame(
        jnp.asarray(img), j_norm.FrameParams(30.0, 28.0, 12.0, 1.6),
        (64, 48), background="random", noise_key=jax.random.PRNGKey(7)))
    jzero = np.asarray(j_norm.sample_frame(
        jnp.asarray(img), j_norm.FrameParams(30.0, 28.0, 12.0, 1.6),
        (64, 48)))
    oob, joob = rnd != zero, jrnd != jzero
    np.testing.assert_array_equal(oob, joob)
    assert 0 < oob.sum() < oob.size
    np.testing.assert_allclose(rnd[~oob], jrnd[~oob], **PIXEL_TOL)
    assert ((rnd[oob] >= 0) & (rnd[oob] < 1)).all()
    again = t_norm.sample_frame(_t(img), fp, (64, 48), background="random",
                                generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(again.numpy(), rnd)
    with pytest.raises(ValueError, match="background"):
        t_norm.sample_frame(_t(img), fp, (64, 48), background="x")


def test_normalize_image_matches_jax():
    img = np.random.RandomState(3).rand(80, 80).astype(np.float32)
    coords = (30.0, 30.0, 52.0, 33.0, 41.0, 56.0)
    want = j_norm.normalize_image(img, coords, out_size=(32, 24))
    got = t_norm.normalize_image(img, coords, out_size=(32, 24),
                                 device="cpu")
    np.testing.assert_allclose(got, want, **PIXEL_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_norm.normalize_image(img, coords, out_size=(32, 24))


def test_extract_centered_patch_matches_jax():
    z = np.random.RandomState(4).rand(260, 256).astype(np.float32)
    fr, fc, tx, ty = t_heads.age_patch_constants()
    want = np.asarray(j_centered(jnp.asarray(z), t_heads.AGE_SAMPLING, fr, fc,
                                 tx, ty, (96, 96)))
    got = t_centered(_t(z), t_heads.AGE_SAMPLING, fr, fc, tx, ty, (96, 96))
    assert got.shape == (1, 96, 96)
    np.testing.assert_allclose(got.numpy(), want, **BOX_PIXEL_TOL)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_extract_patches_rotate_image_idx_matches_jax(method):
    """A stack of images with a per-box image index; boxes partly outside.
    Nearest: pixels whose source coordinate lies within 1e-4 of a rounding
    tie may pick either texel and are excluded, as in tests/test_pallas.py
    (none occur with these seeds; the mask keeps the test honest)."""
    rng = np.random.RandomState(6)
    stack = rng.rand(3, 70, 90).astype(np.float32)
    n = 10
    side = rng.uniform(14.0, 50.0, n)
    x0, y0 = rng.uniform(-8.0, 70.0, n), rng.uniform(-8.0, 50.0, n)
    boxes = np.stack([x0, y0, x0 + side, y0 + side], 1).astype(np.float32)
    angles = rng.uniform(-24.0, 24.0, n).astype(np.float32)
    idx = rng.randint(0, 3, n).astype(np.int32)
    want = np.asarray(j_extract(jnp.asarray(stack), jnp.asarray(boxes),
                                jnp.asarray(angles), (32, 32), method,
                                image_idx=jnp.asarray(idx)))
    got = t_extract(_t(stack), _t(boxes), _t(angles), (32, 32), method,
                    image_idx=_t(idx, torch.int32)).numpy()
    if method == "nearest":
        differ = got != want
        assert differ.mean() < 1e-3
        got = np.where(differ, want, got)
    np.testing.assert_allclose(got, want, **BOX_PIXEL_TOL)
    # each box read its own image: the single-image call gives the same
    for b in range(n):
        one = t_extract(_t(stack[idx[b]]), _t(boxes[b:b + 1]),
                        _t(angles[b:b + 1]), (32, 32), method).numpy()
        np.testing.assert_array_equal(one[0], t_extract(
            _t(stack), _t(boxes), _t(angles), (32, 32), method,
            image_idx=_t(idx, torch.int32)).numpy()[b])
    with pytest.raises(ValueError, match="image_idx"):
        t_extract(_t(stack), _t(boxes), _t(angles), (32, 32), method)


def test_ridge_regression_and_fit_match_jax():
    """fit is float64 numpy on both sides (parameters equal after the
    float32 cast); regression is one float32 dot product: 1e-5."""
    rng = np.random.RandomState(8)
    x = rng.normal(size=(200, 24)).astype(np.float32)
    y = x[:, :10] @ rng.normal(size=10) + 0.1 * rng.normal(size=200)
    jr = JRidge.fit(x, y, input_dim=20)
    tr = TRidge.fit(x, y, input_dim=20)
    assert tr.input_dim == jr.input_dim == 20
    for name in ("w", "b", "clip_lo", "clip_hi", "resid_std"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    np.testing.assert_array_equal(tr.avg_labels.numpy(),
                                  np.asarray(jr.avg_labels))
    probe = (3.0 * rng.normal(size=(50, 20))).astype(np.float32)
    want, want_std = jr.regression(jnp.asarray(probe), estimate_std=True)
    got, got_std = tr.regression(_t(probe), estimate_std=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_std.numpy(), np.asarray(want_std))
    assert (np.asarray(want) == np.asarray(jr.clip_hi)).any()   # clipped
    np.testing.assert_array_equal(tr(_t(probe)).numpy(), got.numpy())


def test_ridge_archive_round_trip(tmp_path):
    """An archive written by the JAX package loads as the port's ridge head
    (and a Gaussian archive still as a Gaussian head); from_jax_params
    builds the same head from the arrays."""
    rng = np.random.RandomState(9)
    x = rng.normal(size=(100, 12)).astype(np.float32)
    jr = JRidge.fit(x, rng.uniform(-5, 5, 100), input_dim=12)
    path = str(tmp_path / "clf_ridge.npz")
    j_art.save_classifier(path, jr, 12)
    tr = t_art.load_classifier(path)
    assert isinstance(tr, TRidge)
    fields = {k: np.asarray(getattr(jr, k))
              for k in ("w", "b", "clip_lo", "clip_hi", "resid_std")}
    built = t_art.from_jax_params(ridge=fields)
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(tr, k).numpy(), v)
        np.testing.assert_array_equal(getattr(built, k).numpy(), v)
    assert not isinstance(t_art.load_classifier(
        os.path.join(ART, "clf_Age.npz")), TRidge)
    with pytest.raises(ValueError, match="exactly one"):
        t_art.from_jax_params(ridge=fields, gaussian={})


def test_detect_with_ridge_pose_heads_matches_jax(random_artifact_dir,  # noqa: F811
                                                  tmp_path):
    """Ridge-decoded pose stages end to end (the JAX suite's own case,
    tests/test_detector.py): the model loads with a ridge head FIRST in the
    classifier list too (DetectionModel.device reads it), and detections
    agree as in tests/test_torch_detect.py (1e-4; eye columns 5e-3)."""
    import shutil
    out = str(tmp_path / "ridge_artifacts")
    shutil.copytree(random_artifact_dir, out)
    rng = np.random.RandomState(5)
    for cname, dim, lo, hi in [("clf_PosX0", 10, -5, 5),
                               ("clf_PosY0", 20, -5, 5),
                               ("clf_PAng0", 20, -10, 10),
                               ("clf_Scale0", 20, 0.75, 0.9)]:
        x = rng.normal(size=(200, dim)).astype(np.float32)
        clf = JRidge.fit(x, rng.uniform(lo, hi, 200), input_dim=dim)
        j_art.save_classifier(os.path.join(out, cname + ".npz"), clf, dim)
    jm = j_detector.DetectionModel.load(out)
    tm = t_detector.DetectionModel.load(out, device="cpu")
    assert isinstance(tm.classifier("PosX0"), TRidge)
    assert not isinstance(tm.classifier("Disc1"), TRidge)
    ridge_first = t_detector.DetectionModel(
        tm.spec, tm.nets, [tm.classifier("PosX0")] + tm.classifiers[1:])
    assert ridge_first.device == torch.device("cpu")
    kw = dict(smallest_face=0.4, bucket_sizes=(256, 1024, 4096),
              cut_offs_face=(1.01,) * 10, matmul_dtype="f32")
    img = np.random.RandomState(3).rand(120, 140).astype(np.float32)
    jd = j_detector.FaceDetector(jm, JConfig(wire_format="f32", **kw))
    td = t_detector.FaceDetector(tm, TConfig(**kw), device="cpu")
    jr, tr = _rows(jd.detect(img)), _rows(td.detect(img))
    assert jr.shape == tr.shape and len(jr) > 0
    eyes = np.zeros(jr.shape[1], bool)
    eyes[5:9] = True
    np.testing.assert_allclose(tr[:, :10][:, ~eyes[:10]],
                               jr[:, :10][:, ~eyes[:10]], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr[:, 5:9], jr[:, 5:9], rtol=0, atol=5e-3)


def test_image_io_round_trip(tmp_path):
    """load_image/save_image against the JAX package's on the same file:
    PNG is lossless, so both loaders return the same array; prescaling
    halves a 120x80 image at prescale_size=60."""
    arr = np.random.RandomState(10).rand(80, 120).astype(np.float32)
    path = str(tmp_path / "img.png")
    t_images.save_image(path, arr)
    from pyfaceanalysis_tpu.io import images as j_images
    for size in (1000, 60, None):
        got, gf = t_images.load_image(path, prescale_size=size)
        want, wf = j_images.load_image(path, prescale_size=size)
        np.testing.assert_array_equal(got, want)
        assert gf == wf
    got, gf = t_images.load_image(path, prescale_size=60)
    assert got.shape == (40, 60) and gf == 0.5 and got.dtype == np.float32
    full, _ = t_images.load_image(path)
    np.testing.assert_allclose(full, arr, rtol=0, atol=1.0 / 255)


@pytest.mark.parametrize("k", [0, 1, 2, 5, 11])
def test_tta_offsets_exact(k):
    np.testing.assert_array_equal(t_heads._tta_offsets(k),
                                  j_heads._tta_offsets(k))


def test_age_patch_zgrid_exact():
    for got, want in zip(t_heads._age_patch_zgrid(),
                         j_heads._age_patch_zgrid()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_label_strings_match_jax():
    vals = [-2.0, -0.1, 0.0, 0.3, 2.0]
    for long_text in (True, False):
        assert t_heads.race_strings(vals, long_text) == \
            j_heads.race_strings(vals, long_text)
        assert t_heads.gender_strings(vals, long_text) == \
            j_heads.gender_strings(vals, long_text)
    d = t_detector.Detection((0, 0, 1, 1), 0.0, (0, 0), (1, 0), 0.1,
                             race_value=1.0, gender_value=-1.0)
    assert (d.race, d.gender) == ("White", "Male")
    assert t_detector.Detection((0, 0, 1, 1), 0.0, (0, 0), (1, 0),
                                0.1).race is None


def _frames(rows):
    c, a, s = j_heads._frame_arrays(rows)
    tc, ta, ts = t_heads._frame_arrays(rows)
    for got, want in ((tc, c), (ta, a), (ts, s)):
        np.testing.assert_array_equal(got, want)
    return c, a, s


def test_sample_age_patches_matches_jax():
    """The composed source->patch bilinear gather over an image stack, on
    frames from real eye rows (one face near the border, so zero fill is
    reached): within 1e-5."""
    rng = np.random.RandomState(11)
    stack = rng.rand(2, 120, 140).astype(np.float32)
    rows = np.concatenate([_ROWS, [[0, 0, 60, 60, 0, 4.0, 20.0, 40.0, 22.0,
                                    0.3]]])
    centers, angles, sfs = _frames(rows)
    idx = np.array([0, 1, 1, 0], np.int32)
    want = np.asarray(j_heads._sample_age_patches(
        jnp.asarray(stack), jnp.asarray(centers), jnp.asarray(angles),
        jnp.asarray(sfs), jnp.asarray(idx)))
    got = t_heads._sample_age_patches(_t(stack), _t(centers), _t(angles),
                                      _t(sfs), _t(idx, torch.int64))
    assert got.shape == (4, 96, 96)
    np.testing.assert_allclose(got.numpy(), want, **PIXEL_TOL)
    assert (want[3] == 0).any() and (want[0] != 0).all()


@pytest.mark.parametrize("tta", [1, 5])
def test_heads_match_jax_shipped_artifacts(shipped_models, tta):
    """estimate_age_race_gender_multi over a stack of two rendered scenes,
    shipped age network and Age/Race/Gender classifiers."""
    jm, tm = shipped_models
    stack = np.stack([_scene(3), _scene(4)])
    rows = np.array([
        [82.0, 63.1, 155.5, 136.6, -0.6, 106.4, 84.8, 130.9, 86.9, 0.1],
        [91.4, 67.7, 156.3, 132.6, 3.5, 113.8, 86.5, 137.2, 88.3, 0.02],
        [99.0, 75.5, 147.5, 124.0, 4.9, 113.2, 87.7, 131.6, 91.2, 0.16]])
    idx = np.array([0, 1, 1], np.int32)
    want = j_heads.estimate_age_race_gender_multi(
        jnp.asarray(stack), rows, idx, jm, tta=tta)
    got = t_heads.estimate_age_race_gender_multi(
        _t(stack), rows, idx, tm, tta=tta)
    for g, w, atol in zip(got, want, (2e-3, 2e-3, 1e-3, 1e-3)):
        assert g.shape == (3,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)
    assert (got[0] >= 16).all() and (got[0] <= 58).all()
    # the single-image entry point is the stack of one
    one = t_heads.estimate_age_race_gender(_t(stack[1]), rows[1:], tm,
                                           tta=tta)
    for g, o in zip(got, one):
        np.testing.assert_allclose(o, g[1:], rtol=0, atol=1e-5)
    empty = t_heads.estimate_age_race_gender(_t(stack[0]), rows[:0], tm)
    assert all(len(e) == 0 for e in empty)


def _rows(dets):
    return np.asarray([(*d.box, d.angle, *d.eye_left, *d.eye_right,
                        d.confidence, d.age, d.age_std, d.race_value,
                        d.gender_value) for d in dets],
                      np.float64).reshape(-1, 14)


@pytest.mark.parametrize("seed,n_faces", [(3, 1), (8, 2)])
def test_detect_with_attributes_matches_jax(shipped_models, seed, n_faces):
    """detect(image) end to end with the heads on SavedNetworksTPU/:
    geometry within 1e-4 (as tests/test_torch_detect.py), age and std
    within 2e-3 years, race and gender values within 1e-3, same labels."""
    jm, tm = shipped_models
    img = _scene(seed)
    kw = dict(matmul_dtype="f32")
    jdets = j_detector.FaceDetector(
        jm, JConfig(wire_format="f32", **kw)).detect(img)
    tdets = t_detector.FaceDetector(tm, TConfig(**kw),
                                    device="cpu").detect(img)
    jr, tr = _rows(jdets), _rows(tdets)
    assert jr.shape == tr.shape and len(jr) == n_faces
    assert np.isfinite(tr).all()
    np.testing.assert_allclose(tr[:, :10], jr[:, :10], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr[:, 10:12], jr[:, 10:12], rtol=0, atol=2e-3)
    np.testing.assert_allclose(tr[:, 12:], jr[:, 12:], rtol=0, atol=1e-3)
    assert [(d.race, d.gender) for d in tdets] == \
        [(d.race, d.gender) for d in jdets]
    # attributes off, or every head disabled: geometry only
    off = t_detector.FaceDetector(
        tm, TConfig(estimate_age=False, estimate_race=False,
                    estimate_gender=False, **kw), device="cpu").detect(img)
    assert len(off) == len(tdets) and all(d.age is None for d in off)


def test_arg_eyes_refined_feeds_refined_eyes_to_heads():
    """_arg_rows: a copy with cols 5:9 replaced by the refined centres only
    when asked and present (as the JAX function)."""
    rows = np.arange(28, dtype=np.float64).reshape(2, 14)
    for cfg_j, cfg_t in ((JConfig(), TConfig()),
                         (JConfig(arg_eyes="refined"),
                          TConfig(arg_eyes="refined"))):
        np.testing.assert_array_equal(t_detector._arg_rows(rows, cfg_t),
                                      j_detector._arg_rows(rows, cfg_j))
        np.testing.assert_array_equal(
            t_detector._arg_rows(rows[:, :10], cfg_t),
            j_detector._arg_rows(rows[:, :10], cfg_j))
    out = t_detector._arg_rows(rows, TConfig(arg_eyes="refined"))
    assert out.shape == (2, 10) and (out[:, 5:9] == rows[:, 10:14]).all()
    assert rows[0, 5] == 5.0                    # the input is not mutated


def test_save_age_estimation_images(shipped_models, tmp_path):
    """The opt-in debug output writes one 96x96 JPEG per face, numbered on
    from start_index, equal (within JPEG loss, 0.06) to the JAX package's."""
    _, tm = shipped_models
    img = _scene(3)
    rows = np.array([[82.0, 63.1, 155.5, 136.6, -0.6, 106.4, 84.8, 130.9,
                      86.9, 0.1]])
    nxt = t_heads.save_age_estimation_images(
        _t(img), rows, pattern=str(tmp_path / "t%03d.jpg"), start_index=4)
    jnxt = j_heads.save_age_estimation_images(
        jnp.asarray(img), rows, pattern=str(tmp_path / "j%03d.jpg"),
        start_index=4)
    assert nxt == jnxt == 5
    got, _ = t_images.load_image(str(tmp_path / "t004.jpg"))
    want, _ = t_images.load_image(str(tmp_path / "j004.jpg"))
    assert got.shape == (96, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.06)
