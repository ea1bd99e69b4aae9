"""PyTorch port vs the JAX package: the fused batch path and the stream.

Both sides run on the CPU at ``matmul_dtype="f32"``. Comparisons with the
JAX package use the shipped ``SavedNetworksTPU/`` on 200x240 rendered
scenes; the port is held against itself (fused against sequential, stream
against batch, chunks against whole) on the JAX suite's random-weight 32x32
artifacts with its small settings, where every window survives and both
compaction rungs fire. Random weights turn a 1e-5 px difference between the
two frameworks' f32 products into pixels through the nearest re-sampling
(ROADMAP.md section 3), and XLA's own fused and sequential programs drift
apart the same way on some scenes: of the rendered 200x240 scenes of seeds
0 to 11, fused in batches of three consecutive seeds at f32 operands, the
JAX package's ``detect_batch`` and ``detect`` disagree on seed 3 (9.5 px)
and seed 10 (0.02 px) and agree within 6e-5 px on the other ten. The port's
fused program equals its sequential one bit for bit on this CPU, and its
``detect`` equals JAX's on seed 3 (tests/test_torch_detect.py), so on those
two scenes it sides with JAX's sequential program. ``SCENES`` are three of
the ten on which JAX agrees with itself, with 2, 1 and 1 faces. The fused
level-space route (stacked pyramid, folded levels, tiled scales), the only
one the card runs, is held against JAX with its Pallas kernels in interpret
mode in test_fused_run_cascade_ref_matches_jax_interpret and
test_fused_localize_eyes_level_route_matches_jax_interpret; the
``detect_batch`` comparisons run at ``pallas_refine="auto"``, which on the
CPU is the canvas route on both sides.
Tolerances:

- ``build_pyramid_batch``, ``make_batched_grid_state``, the u16 pack:
  copies and integer arithmetic: exact;
- fused ``run_cascade`` with identity networks and constant classifiers:
  the same float operations on both sides: 1e-4, masks exact;
- ``detect_batch`` / ``detect_stream`` against the JAX package: geometry
  and confidence 1e-4, age and its std 2e-3 years, race and gender 1e-3,
  as the single-image tests (tests/test_torch_detect.py,
  tests/test_torch_heads.py). At ``wire_format="u16"`` both sides
  quantise, and a value within 1e-5 of a rounding boundary may land one
  step apart: one wire step (1/16 px, 1/16384 confidence) plus the f32
  tolerance, and the heads see eyes up to one step apart (age 0.7 years,
  race and gender 0.15; measured 0.6 and 0.1);
- the port against itself (fused against sequential, stream against batch,
  chunks against whole): atol 1e-3, the JAX suite's own
  (tests/test_detector.py); on this CPU they agree far closer.
"""

import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_detector import random_artifact_dir  # noqa: F401  (fixture)
from test_engine import _const_classifier, _identity_net
from test_torch_detect import (
    _STAGE_VALUES,
    _identity_port,
    _port_classifier,
    _scene,
)
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.engine import cascade as t_cascade
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.engine import eyes as t_eyes
from pyfaceanalysis_torch.ops.pyramid import build_pyramid as t_pyramid
from pyfaceanalysis_torch.ops.pyramid import build_pyramid_batch as t_pyr_b
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.config import NetGeometry
from pyfaceanalysis_tpu.engine import cascade as j_cascade
from pyfaceanalysis_tpu.engine import detector as j_detector
from pyfaceanalysis_tpu.engine import eyes as j_eyes
from pyfaceanalysis_tpu.ops import pallas_gather as j_pallas_gather
from pyfaceanalysis_tpu.ops.pyramid import build_pyramid_batch as j_pyr_b

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "SavedNetworksTPU")
SCENES = (8, 5, 7)              # 2, 1 and 1 faces
SMALL = dict(smallest_face=0.4, bucket_sizes=(256, 1024, 4096),
             cut_offs_face=(1.01,) * 10, matmul_dtype="f32")
SELF_TOL = dict(rtol=1e-4, atol=1e-3)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _rows(dets):
    """(n, 14): geometry, confidence, then the attributes (NaN if off)."""
    def attr(v):
        return np.nan if v is None else v
    return np.asarray([(*d.box, d.angle, *d.eye_left, *d.eye_right,
                        d.confidence, attr(d.age), attr(d.age_std),
                        attr(d.race_value), attr(d.gender_value))
                       for d in dets], np.float64).reshape(-1, 14)


def _images(seed, n, hw=(100, 120)):
    rng = np.random.RandomState(seed)
    return [rng.rand(*hw).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def models(random_artifact_dir):  # noqa: F811
    return (j_detector.DetectionModel.load(random_artifact_dir),
            t_detector.DetectionModel.load(random_artifact_dir, device="cpu"))


@pytest.fixture(scope="module")
def shipped():
    return (j_detector.DetectionModel.load(ART),
            t_detector.DetectionModel.load(ART, device="cpu"))


def _detectors(models, **kw):
    """(JAX detector, port detector) on the random artifacts."""
    jm, tm = models
    cfg = dict(SMALL, **kw)
    return (j_detector.FaceDetector(jm, JConfig(**cfg)),
            t_detector.FaceDetector(tm, TConfig(**cfg), device="cpu"))


def _shipped_detectors(shipped, **kw):
    jm, tm = shipped
    cfg = dict(matmul_dtype="f32", **kw)
    return (j_detector.FaceDetector(jm, JConfig(**cfg)),
            t_detector.FaceDetector(tm, TConfig(**cfg), device="cpu"))


def _assert_same_lists(got, want, px_tol, conf_tol=1e-4, age_tol=2e-3,
                       label_tol=1e-3):
    assert len(got) == len(want)
    for g_dets, w_dets in zip(got, want):
        g, w = _rows(g_dets), _rows(w_dets)
        assert g.shape == w.shape
        kw = dict(rtol=0, equal_nan=True)
        np.testing.assert_allclose(g[:, :9], w[:, :9], atol=px_tol, **kw)
        np.testing.assert_allclose(g[:, 9], w[:, 9], atol=conf_tol, **kw)
        np.testing.assert_allclose(g[:, 10:12], w[:, 10:12], atol=age_tol,
                                   **kw)
        np.testing.assert_allclose(g[:, 12:], w[:, 12:], atol=label_tol,
                                   **kw)


# One u16 wire step on both sides, plus the f32 tolerance.
U16_TOL = dict(px_tol=1e-4 + 1 / 16, conf_tol=1e-4 + 1 / 16384, age_tol=0.7,
               label_tol=0.15)


def test_build_pyramid_batch_matches_jax():
    """Image-major (B*L, lh, lw) stack: exact, and equal to the per-image
    pyramids stacked."""
    stack = np.random.RandomState(0).rand(3, 100, 120).astype(np.float32)
    scales, level_hw = (1.5, 2.25, 3.4, 1.0), (128, 256)
    want = np.asarray(j_pyr_b(jnp.asarray(stack), scales, level_hw))
    got = t_pyr_b(_t(stack), scales, level_hw)
    assert got.shape == (12, 128, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):
        assert torch.equal(got[4 * b: 4 * b + 4],
                           t_pyramid(_t(stack[b]), scales, level_hw))


@pytest.mark.parametrize("n_images", [1, 3])
@pytest.mark.parametrize("hw,smallest_face", [((100, 120), 0.2),
                                              ((200, 240), 0.2),
                                              ((200, 240), 0.4)])
def test_batched_grid_state_matches_jax(n_images, hw, smallest_face):
    """Tiled grid, sentinel img_idx on the padding rows, folded crop
    levels: every field exact. At smallest_face 0.4 a crop origin leaves
    its level and both packages give no pyramid info."""
    geom = NetGeometry()
    cfg = dict(smallest_face=smallest_face, bucket_sizes=(256, 1024, 4096))
    js, jn, jp = j_cascade.make_batched_grid_state(
        hw[1], hw[0], geom, JConfig(**cfg), n_images)
    ts, tn, tp = t_cascade.make_batched_grid_state(
        hw[1], hw[0], geom, TConfig(**cfg), n_images)
    assert jn == tn > 0
    assert (jp is None) == (tp is None) == (smallest_face == 0.4)
    if tp is not None:
        assert jp.scales == tp.scales and jp.level_hw == tp.level_hw
        np.testing.assert_array_equal(tp.crops.numpy(), np.asarray(jp.crops))
        assert tp.crops.dtype == torch.int32
        L = len(tp.scales)
        assert int(tp.crops[: n_images * tn, 0].max()) // L == n_images - 1
    assert ts.img_idx.dtype == torch.int32
    for a, b in zip(ts, js):
        assert a.dtype == _t(np.asarray(b), None).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = ts.img_idx.numpy()
    assert (idx[: n_images * tn] == np.repeat(np.arange(n_images), tn)).all()
    assert (idx[n_images * tn:] == n_images).all()
    assert t_cascade.compacted_rows_per_image(
        (), TConfig(), 7) == j_cascade.compacted_rows_per_image(
        (), JConfig(), 7) == 7


def test_batched_grid_state_empty_grid():
    geom = NetGeometry()
    cfg = dict(smallest_face=0.9, bucket_sizes=(256, 1024, 4096))
    _, jn, jp = j_cascade.make_batched_grid_state(8, 8, geom,
                                                  JConfig(**cfg), 2)
    _, tn, tp = t_cascade.make_batched_grid_state(8, 8, geom,
                                                  TConfig(**cfg), 2)
    assert jn == tn == 0 and jp is None and tp is None


def test_fused_run_cascade_matches_jax_canvas_path(models):
    """Fused run_cascade (3 images, pallas_refine="off": iter-0 crops from
    the stacked pyramid, canvas gather with image_idx afterwards) over the
    17-stage plan with identity networks and constant classifiers, so both
    sides do the same float operations. Every window has the same
    confidence: only a STABLE composite-key sort keeps the JAX order
    through both per-image rungs."""
    jm, _ = models
    stack = np.stack([_scene(3, (100, 120)), _scene(4, (100, 120)),
                      _scene(5, (100, 120))])
    kw = dict(matmul_dtype="f32", pallas_refine="off", mid_compact=48,
              mid_compact2=24, cut_offs_face=(0.9,) * 10,
              last_cut_off_face=0.9, bucket_sizes=(256, 1024, 4096),
              detection_contrast_normalize=False)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    geom = NetGeometry()          # 64x64 patches for the identity network
    specs, params = _identity_net()
    jplan = tuple(p._replace(net_idx=min(p.net_idx, 0), input_dim=4)
                  for p in jm.plan)
    tplan = tuple(t_cascade.StagePlan(*p) for p in jplan)
    jclfs = tuple(_const_classifier(_STAGE_VALUES[p.kind]) for p in jplan)
    js, n_real, jp = j_cascade.make_batched_grid_state(120, 100, geom, jcfg,
                                                       3)
    ts, _, tp = t_cascade.make_batched_grid_state(120, 100, geom, tcfg, 3)
    assert n_real > 48
    jpyr = j_pyr_b(jnp.asarray(stack), jp.scales, jp.level_hw)
    jout = j_cascade.run_cascade(
        jplan, (specs,), geom, jcfg, (64, 64), jnp.asarray(stack),
        ((params[0],),), jclfs, js, pyramid=jpyr, crops=jp.crops,
        pyr_scales=jnp.asarray(jp.scales * 3, jnp.float32), n_images=3,
        n_per_image=n_real)
    tout = t_cascade.run_cascade(
        tplan, (_identity_port(specs, params),), geom, tcfg, (64, 64),
        _t(stack), tuple(_port_classifier(c) for c in jclfs), ts,
        pyramid=_t(np.asarray(jpyr)), crops=tp.crops,
        pyr_scales=torch.tensor(tp.scales * 3), n_images=3,
        n_per_image=n_real)
    n_last = t_cascade.compacted_rows_per_image(tplan, tcfg, n_real)
    assert n_last == j_cascade.compacted_rows_per_image(jplan, jcfg, n_real)
    assert tout.mask.shape[0] == 3 * n_last == np.asarray(jout.mask).shape[0]
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_array_equal(tout.img_idx.numpy(),
                                  np.asarray(jout.img_idx))
    assert (tout.img_idx.numpy() == np.repeat(np.arange(3), n_last)).all()
    assert np.asarray(jout.mask).any()
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_fused_run_cascade_ref_matches_jax_interpret():
    """The fused LEVEL-SPACE route, the one the card runs (stacked pyramid,
    image-folded levels, tiled scales, a per-image rung that gathers the
    levels), with the plain versions against the JAX package's fused
    program with both Pallas kernels in interpret mode. Two images, four
    windows each (three on a unit level, one on the 2x level), identity
    network, constant classifiers, integer level coordinates: within 6e-3,
    the JAX suite's bound for its gather kernel's bf16 texels, as
    tests/test_torch_detect.py::test_run_cascade_ref_matches_jax_interpret
    (measured 0.0); masks and image indices exact; "on" equals "ref"."""
    geom = NetGeometry()
    stack = np.random.RandomState(7).rand(2, 160, 160).astype(np.float32)
    specs, params = _identity_net()
    jclfs = tuple(_const_classifier(v) for v in (0.5, 2.0, 0.5))
    plan = (j_cascade.StagePlan("Disc", 0, True, 0, 0, 4),
            j_cascade.StagePlan("PosX", 0, False, -1, 1, 4),
            j_cascade.StagePlan("Disc", 1, True, 0, 2, 4))
    n, L, scales = 4, 2, (1.0, 2.0)
    boxes = np.asarray([[8, 8, 71, 71], [40, 30, 103, 93],
                        [16, 16, 143, 143], [16, 80, 79, 143]], np.float32)
    level = np.asarray([0, 0, 1, 0])
    pitch = np.asarray(scales)[level]
    crops = np.stack([level, boxes[:, 1] / pitch, boxes[:, 0] / pitch],
                     1).astype(np.int32)
    side = boxes[:, 2] - boxes[:, 0] + 1
    st = dict(boxes=boxes, angles=np.zeros(n, np.float32),
              mask=np.ones(n, bool), conf=np.ones(n, np.float32),
              orig_cx=(boxes[:, 0] + boxes[:, 2]) / 2,
              orig_cy=(boxes[:, 1] + boxes[:, 3]) / 2,
              max_dx=np.full(n, 12.5, np.float32),
              max_dy=np.full(n, 6.25, np.float32),
              base_side=np.hypot(side, side).astype(np.float32))
    st = {k: np.concatenate([v, v]) for k, v in st.items()}
    idx = np.repeat([0, 1], n).astype(np.int32)
    fcrops = np.concatenate([crops, crops + np.array([L, 0, 0], np.int32)])
    jpyr = j_pyr_b(jnp.asarray(stack), scales, (160, 256))
    # The rung keeps 3 of each image's 4 tied windows: stable order.
    kw = dict(bucket_sizes=(2 * n,), mid_compact=3, mid_compact2=0)
    jout = j_cascade.run_cascade(
        plan, (specs,), geom, JConfig(pallas_refine="interpret", **kw),
        (64, 64), jnp.asarray(stack), ((params[0],),), jclfs,
        j_cascade.CascadeState(**{k: jnp.asarray(v) for k, v in st.items()},
                               img_idx=jnp.asarray(idx)),
        pyramid=jpyr, crops=jnp.asarray(fcrops),
        pyr_scales=jnp.asarray(scales * 2, jnp.float32), n_images=2,
        n_per_image=n)
    touts = {}
    for mode in ("ref", "on"):
        touts[mode] = t_cascade.run_cascade(
            tuple(t_cascade.StagePlan(*p) for p in plan),
            (_identity_port(specs, params),), geom,
            TConfig(pallas_refine=mode, **kw), (64, 64), _t(stack),
            tuple(_port_classifier(c) for c in jclfs),
            t_cascade.CascadeState(**{k: _t(v, None) for k, v in st.items()},
                                   img_idx=_t(idx, torch.int32)),
            pyramid=_t(np.asarray(jpyr)), crops=_t(fcrops, torch.int32),
            pyr_scales=torch.tensor(scales * 2), n_images=2, n_per_image=n)
    tout = touts["ref"]
    assert tout.mask.shape[0] == 6 == np.asarray(jout.mask).shape[0]
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_array_equal(tout.img_idx.numpy(),
                                  np.asarray(jout.img_idx))
    assert tout.mask.all() and float(tout.boxes[0, 0]) != 8.0   # PosX moved
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=6e-3)
    for a, b in zip(touts["on"], tout):
        assert torch.equal(a, b)


def test_fused_run_cascade_ref_route_equals_per_image():
    """The level-space route in fused mode (stacked pyramid, folded levels,
    tiled scales; plain versions, which the kernel wrappers hand CPU
    tensors to) gives each image the rows its own single-image cascade
    gives: exact, and "on" equals "ref"."""
    geom = NetGeometry()
    rng = np.random.RandomState(7)
    stack = rng.rand(2, 160, 160).astype(np.float32)
    specs, params = _identity_net()
    tnet = _identity_port(specs, params)
    tclfs = tuple(_port_classifier(_const_classifier(v))
                  for v in (0.5, 2.0, 0.5))
    plan = (t_cascade.StagePlan("Disc", 0, True, 0, 0, 4),
            t_cascade.StagePlan("PosX", 0, False, -1, 1, 4),
            t_cascade.StagePlan("Disc", 1, True, 0, 2, 4))
    n = 4
    boxes = np.asarray([[8, 8, 71, 71], [40, 30, 103, 93],
                        [70, 60, 133, 123], [16, 80, 79, 143]], np.float32)
    crops = np.stack([np.zeros(n), boxes[:, 1], boxes[:, 0]],
                     1).astype(np.int32)
    st = dict(boxes=boxes, angles=np.zeros(n, np.float32),
              mask=np.ones(n, bool), conf=np.ones(n, np.float32),
              orig_cx=(boxes[:, 0] + boxes[:, 2]) / 2,
              orig_cy=(boxes[:, 1] + boxes[:, 3]) / 2,
              max_dx=np.full(n, 12.5, np.float32),
              max_dy=np.full(n, 6.25, np.float32),
              base_side=np.full(n, np.hypot(64, 64), np.float32))
    single = t_cascade.CascadeState(**{k: _t(v, None) for k, v in st.items()})
    fused = t_cascade.CascadeState(
        **{k: _t(np.concatenate([v, v]), None) for k, v in st.items()},
        img_idx=_t(np.repeat([0, 1], n), torch.int32))
    L = 2                                      # a unit level and a 2x level
    pyr = t_pyr_b(_t(stack), (1.0, 2.0), (160, 256))
    fcrops = np.concatenate([crops, crops + np.array([L, 0, 0], np.int32)])
    outs = {}
    for mode in ("ref", "on"):
        cfg = TConfig(bucket_sizes=(n,), mid_compact=0, pallas_refine=mode)
        outs[mode] = t_cascade.run_cascade(
            plan, (tnet,), geom, cfg, (64, 64), _t(stack), tclfs, fused,
            pyramid=pyr, crops=_t(fcrops, torch.int32),
            pyr_scales=torch.tensor([1.0, 2.0] * 2), n_images=2,
            n_per_image=n)
        for b in range(2):
            one = t_cascade.run_cascade(
                plan, (tnet,), geom, cfg, (64, 64), _t(stack[b]), tclfs,
                single, pyramid=pyr[L * b: L * b + L],
                crops=_t(crops, torch.int32),
                pyr_scales=torch.tensor([1.0, 2.0]))
            for a, o in zip(outs[mode][:9], one[:9]):
                assert torch.equal(a[n * b: n * b + n], o)
    for a, b in zip(outs["on"], outs["ref"]):
        assert torch.equal(a, b)


def test_fused_localize_eyes_matches_jax(models):
    """One eye pass over a stack with image_idx (canvas gather, the JAX CPU
    route): new boxes within 1e-4 px, the too-far magnitude within 5e-4,
    as the single-image test. With a stacked pyramid and the plain level
    sampler, each box reads ITS image: the result equals the single-image
    pass on that image (exact)."""
    jm, tm = models
    rng = np.random.RandomState(4)
    stack = rng.rand(3, 100, 120).astype(np.float32)
    n = 12
    side = rng.uniform(10.0, 40.0, n)
    x0, y0 = rng.uniform(-5.0, 90.0, n), rng.uniform(-5.0, 70.0, n)
    boxes = np.stack([x0, y0, x0 + side, y0 + side], 1).astype(np.float32)
    angles = rng.uniform(-24.0, 24.0, n).astype(np.float32)
    idx = rng.randint(0, 3, n).astype(np.int32)
    hw = (jm.spec.eye_geom.subimage_height, jm.spec.eye_geom.subimage_width)
    jnet = jm.nets["net_eye"]
    jb, jreg = j_eyes.localize_eyes(
        jnet.specs, jm.clf_input_dim("EyeLX"), jm.clf_input_dim("EyeLY"), hw,
        jnp.asarray(stack), tuple(jnet.params), jm.classifier("EyeLX"),
        jm.classifier("EyeLY"), jnp.asarray(boxes), jnp.asarray(angles),
        image_idx=jnp.asarray(idx), n_base_levels=4)
    args = (tm.nets["net_eye"], tm.clf_input_dim("EyeLX"),
            tm.clf_input_dim("EyeLY"), hw)
    clfs = (tm.classifier("EyeLX"), tm.classifier("EyeLY"))
    tb, treg = t_eyes.localize_eyes(
        *args, _t(stack), *clfs, _t(boxes), _t(angles),
        image_idx=_t(idx, torch.int32), n_base_levels=4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), rtol=0,
                               atol=5e-4)
    # Level route: base ladder of 4 levels (the last one native), folded.
    scales, level_hw = (1.2, 1.8, 2.7, 1.0), (128, 256)
    pyr = t_pyr_b(_t(stack), scales, level_hw)
    from pyfaceanalysis_torch.ops.patches import sample_patches_pyramid_ref
    fb, freg = t_eyes.localize_eyes(
        *args, _t(stack), *clfs, _t(boxes), _t(angles), pyramid=pyr,
        pyr_scales=torch.tensor(scales * 3),
        level_sampler=sample_patches_pyramid_ref,
        image_idx=_t(idx, torch.int32), n_base_levels=4)
    for b in range(3):
        sel = np.flatnonzero(idx == b)
        ob, oreg = t_eyes.localize_eyes(
            *args, _t(stack[b]), *clfs, _t(boxes[sel]), _t(angles[sel]),
            pyramid=pyr[4 * b: 4 * b + 4], pyr_scales=torch.tensor(scales),
            level_sampler=sample_patches_pyramid_ref)
        assert torch.equal(fb[sel], ob) and torch.equal(freg[sel], oreg)


def test_fused_localize_eyes_level_route_matches_jax_interpret(shipped,
                                                               monkeypatch):
    """The eye pass of a fused batch on the level-space route, the one the
    card runs (level chosen on the base ladder, then image-folded; stacked
    pyramid; tiled scales; the box no level covers re-sampled from the
    canvas stack by image index), with the plain sampler against the JAX
    function's own level route with its Pallas gather in interpret mode.
    JAX takes that route only on a TPU backend, so the test tells it so
    while it traces and hands it the interpreter. The pyramid's values are
    rounded to multiples of 1/128, which the JAX kernel's bf16 texels hold
    exactly, so its approximation (6e-3 per pixel, some 0.1 px after the
    eye network) does not blur the comparison: new boxes within 1e-3 px
    (measured 6e-5 on level-sampled boxes, 7e-4 on the canvas-sampled
    one), the too-far magnitude within 5e-4 as on the canvas route. The
    canvas route differs from this one by up to 2 px on these boxes, so a
    wrong level or image would show."""
    jm, tm = shipped
    stack = np.stack([_scene(s, (100, 120)) for s in (3, 4, 5)])
    rng = np.random.RandomState(4)
    n = 14
    side = rng.uniform(10.0, 60.0, n)
    side[0] = 300.0                                  # no level covers it
    x0, y0 = rng.uniform(-5.0, 90.0, n), rng.uniform(-5.0, 70.0, n)
    boxes = np.stack([x0, y0, x0 + side, y0 + side], 1).astype(np.float32)
    angles = rng.uniform(-24.0, 24.0, n).astype(np.float32)
    idx = rng.randint(0, 3, n).astype(np.int32)
    hw = (jm.spec.eye_geom.subimage_height, jm.spec.eye_geom.subimage_width)
    scales, level_hw = (0.5, 0.7, 2.7, 1.0), (256, 256)
    jpyr = jnp.round(j_pyr_b(jnp.asarray(stack), scales, level_hw)
                     * 128.0) / 128.0
    jnet = jm.nets["net_eye"]
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        m.setattr(j_pallas_gather, "sample_patches_pyramid",
                  functools.partial(j_pallas_gather.sample_patches_pyramid,
                                    interpret=True))
        jb, jreg = j_eyes.localize_eyes(
            jnet.specs, jm.clf_input_dim("EyeLX"), jm.clf_input_dim("EyeLY"),
            hw, jnp.asarray(stack), tuple(jnet.params),
            jm.classifier("EyeLX"), jm.classifier("EyeLY"),
            jnp.asarray(boxes), jnp.asarray(angles), pyramid=jpyr,
            pyr_scales=jnp.asarray(scales * 3, jnp.float32),
            image_idx=jnp.asarray(idx), n_base_levels=4)
        jb, jreg = np.asarray(jb), np.asarray(jreg)
    from pyfaceanalysis_torch.ops.patches import sample_patches_pyramid_ref
    args = (tm.nets["net_eye"], tm.clf_input_dim("EyeLX"),
            tm.clf_input_dim("EyeLY"), hw, _t(stack), tm.classifier("EyeLX"),
            tm.classifier("EyeLY"), _t(boxes), _t(angles))
    kw = dict(image_idx=_t(idx, torch.int32), n_base_levels=4)
    tb, treg = t_eyes.localize_eyes(
        *args, pyramid=_t(np.asarray(jpyr)),
        pyr_scales=torch.tensor(scales * 3),
        level_sampler=sample_patches_pyramid_ref, **kw)
    levels, no_cover = t_eyes._eye_levels(torch.tensor(scales),
                                          _t(side + 1.0))
    assert no_cover.tolist() == [True] + [False] * (n - 1)
    assert len(set(levels[1:].tolist())) >= 3        # several levels in use
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(treg.numpy(), jreg, rtol=0, atol=5e-4)
    cb, _ = t_eyes.localize_eyes(*args, **kw)        # the canvas route
    assert float((cb - tb).abs().max()) > 0.5


@pytest.mark.parametrize("wire", ["f32", "u16"])
@pytest.mark.parametrize("mode", ["fused", "async"])
def test_detect_batch_matches_jax(shipped, mode, wire):
    """detect_batch of 3 scenes on the shipped artifacts, with attributes,
    against the JAX package in both batch modes and wire formats (the
    async mode never packs the wire)."""
    jd, td = _shipped_detectors(shipped, batch_mode=mode, wire_format=wire)
    imgs = [_scene(s) for s in SCENES]
    want = jd.detect_batch(imgs)
    got = td.detect_batch(imgs)
    assert [len(d) for d in got] == [2, 1, 1]
    assert td.windows_scanned == jd.windows_scanned > 0
    quantised = wire == "u16" and mode == "fused"
    _assert_same_lists(got, want, **(U16_TOL if quantised
                                     else dict(px_tol=1e-4)))
    r = np.concatenate([_rows(d) for d in got])
    assert np.isfinite(r).all()
    # The u16 wire leaves every coordinate a multiple of 1/16 px.
    assert np.array_equal(r[:, :9] * 16,
                          np.round(r[:, :9] * 16)) == quantised


def test_detect_batch_fused_matches_sequential_and_async(models):
    """The port against itself at the f32 wire: fused == async ==
    sequential detect, attributes included (the JAX suite's tolerance)."""
    _, fused = _detectors(models, wire_format="f32")
    _, asyn = _detectors(models, wire_format="f32", batch_mode="async")
    imgs = _images(3, 3)
    seq = [fused.detect(im) for im in imgs]
    for got in (fused.detect_batch(imgs), asyn.detect_batch(imgs)):
        assert [len(d) for d in got] == [len(d) for d in seq]
        for g_dets, s_dets in zip(got, seq):
            for g, s in zip(g_dets, s_dets):
                np.testing.assert_allclose(g.box, s.box, **SELF_TOL)
                np.testing.assert_allclose(
                    [g.age, g.age_std, g.race_value, g.gender_value],
                    [s.age, s.age_std, s.race_value, s.gender_value],
                    rtol=0, atol=1e-2)
    assert sum(len(d) for d in seq) > 20
    assert fused.detect_batch([]) == []


def test_detect_batch_chunks_at_max_fused_batch(models, shipped):
    """5 images at max_fused_batch=2: chunks of 2, 2 and 1 (a one-image
    fused program), same results as sequential
    detect; and 3 scenes in chunks of 2 and 1 against the JAX package."""
    _, td = _detectors(models, wire_format="f32", max_fused_batch=2)
    imgs = _images(5, 5)
    chunked = td.detect_batch(imgs, estimate_attributes=False)
    assert len(chunked) == 5
    assert sorted(k[2] for k in td._grid_cache) == [1, 2]
    per_image = [td.detect(im, estimate_attributes=False) for im in imgs]
    _assert_same_lists(chunked, per_image, 1e-3)
    jd, sd = _shipped_detectors(shipped, wire_format="f32",
                                max_fused_batch=2)
    scenes = [_scene(s) for s in SCENES]
    _assert_same_lists(sd.detect_batch(scenes), jd.detect_batch(scenes),
                       1e-4)


def test_one_image_batch_takes_the_level_route(shipped, monkeypatch):
    """A batch of one image (the tail chunk of a chunked batch) goes
    through the level-space samplers like any fused batch: with
    pallas_refine="ref" every refinement extraction and the eye pass call
    the plain level sampler (the kernel wrapper on the card), and the
    result equals detect's at "ref" (same row count: 1e-3, the JAX suite's
    fused-against-sequential tolerance; on this CPU they are equal)."""
    _, td = _shipped_detectors(shipped, wire_format="f32",
                               pallas_refine="ref")
    calls = []
    plain = t_cascade.sample_patches_pyramid_ref

    def counted(*a, **kw):
        calls.append(a[3].shape[0])
        return plain(*a, **kw)

    monkeypatch.setattr(t_cascade, "sample_patches_pyramid_ref", counted)
    img = _scene(8)
    got = td.detect_batch([img])
    n_extract = sum(st.extract for st in td.model.plan)
    assert len(calls) == n_extract - 1 + td.config.eye_iters
    want = td.detect(img)
    assert len(want) == 2
    _assert_same_lists(got, [want], 1e-3)


def test_detect_batch_ragged_and_tracking_fall_back(models):
    """Images of differing sizes, and tracking mode, go through detect()
    image by image (the JAX package's rule): no fused program is built."""
    _, td = _detectors(models, wire_format="f32")
    ragged = [_images(1, 1)[0], _images(2, 1, (90, 110))[0]]
    got = td.detect_batch(ragged, estimate_attributes=False)
    want = [td.detect(im, estimate_attributes=False) for im in ragged]
    _assert_same_lists(got, want, 0.0, 0.0)
    assert sum(len(d) for d in got) > 0
    assert not any(k[2] for k in td._grid_cache)
    _, tracker = _detectors(models, wire_format="f32",
                            track_single_face=True)
    tracker.detect_batch(_images(3, 2), estimate_attributes=False)
    assert not any(k[2] for k in tracker._grid_cache)
    assert tracker.face_has_been_found


@pytest.mark.parametrize("mode", ["fused", "async"])
def test_detect_batch_empty_grid(models, mode):
    """Images below the scale envelope: no window, empty lists."""
    jm, tm = models
    cfg = dict(smallest_face=0.9, bucket_sizes=(256, 1024, 4096),
               batch_mode=mode)
    tiny = [np.zeros((8, 8), np.float32) for _ in range(2)]
    td = t_detector.FaceDetector(tm, TConfig(**cfg), device="cpu")
    assert td.detect_batch(tiny) == [[], []]
    assert td.windows_scanned == 0
    assert list(td.detect_stream([tiny])) == [[[], []]]
    jd = j_detector.FaceDetector(jm, JConfig(**cfg))
    assert jd.detect_batch(tiny) == [[], []]


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["queue", "three_stage"])
def test_detect_stream_matches_detect_batch(models, prefetch):
    """Both forms of detect_stream yield detect_batch's results per batch,
    in order, across a ragged batch (flush + fall-back), a below-envelope
    batch and a final flush with depth > remaining batches."""
    _, td = _detectors(models, stream_push_prefetch=prefetch)
    rng = np.random.RandomState(11)
    batches = [
        [rng.rand(100, 120).astype(np.float32) for _ in range(2)],
        [rng.rand(100, 120).astype(np.float32) for _ in range(3)],
        [rng.rand(100, 120).astype(np.float32),      # ragged sizes
         rng.rand(90, 110).astype(np.float32)],
        [np.zeros((8, 8), np.float32)] * 2,          # below the envelope
        [rng.rand(100, 120).astype(np.float32) for _ in range(2)],
    ]
    streamed = list(td.detect_stream(iter(batches)))
    assert len(streamed) == len(batches)
    for images, got in zip(batches, streamed):
        _assert_same_lists(got, td.detect_batch(images), 1e-3, age_tol=1e-2,
                           label_tol=1e-2)
    assert streamed[3] == [[], []]
    assert min(len(d) for b in (0, 1, 2, 4) for d in streamed[b]) > 0
    geometry = [[[dataclasses.replace(d, age=None, age_std=None,
                                      race_value=None, gender_value=None)
                  for d in dets] for dets in b] for b in streamed]
    for depth in (1, 10):
        again = list(td.detect_stream(batches, estimate_attributes=False,
                                      depth=depth))
        assert again == geometry


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["queue", "three_stage"])
def test_detect_stream_matches_jax(shipped, prefetch):
    """The stream on the shipped artifacts at the default config (u16
    wire) against the JAX package's stream, batch by batch, in order."""
    jd, td = _shipped_detectors(shipped, stream_push_prefetch=prefetch)
    batches = [[_scene(8), _scene(5)], [_scene(7), _scene(8)],
               [_scene(5), _scene(7)]]
    got = list(td.detect_stream(batches))
    want = list(jd.detect_stream(batches))
    assert [[len(d) for d in b] for b in got] == [[2, 1], [1, 2], [1, 1]]
    for g, w in zip(got, want):
        _assert_same_lists(g, w, **U16_TOL)


def test_detect_stream_threads_wind_down_and_errors_surface(models):
    """Closing the generator early must not hang: both helper threads end.
    An error in the batch iterable is raised to the consumer."""
    _, td = _detectors(models)
    batch = _images(17, 2)
    gen = td.detect_stream([batch] * 6, estimate_attributes=False)
    next(gen)
    gen.close()
    for t in threading.enumerate():
        if t.name in ("pfa-stream-push", "pfa-stream-finish"):
            t.join(timeout=10.0)
            assert not t.is_alive()

    def broken():
        yield batch
        raise OSError("camera unplugged")

    gen = td.detect_stream(broken(), estimate_attributes=False)
    with pytest.raises(OSError, match="unplugged"):
        list(gen)


def test_u16_wire_pack_matches_jax_and_round_trips(shipped):
    """The device-side pack of a fused f32 block equals the JAX package's
    pack arithmetic (detector.py: round half to even, clip, uint16) on the
    same block (integers: exact), the port's u16 program returns exactly
    that pack, and it unpacks to within half a step of the f32 block."""
    _, td = _shipped_detectors(shipped, wire_format="u16")
    _, tf = _shipped_detectors(shipped, wire_format="f32")
    imgs = [_scene(s) for s in SCENES]
    packed = td._dispatch_fused(imgs)[1].numpy()
    ref = tf._dispatch_fused(imgs)[1]
    assert packed.dtype == np.uint16 and packed.shape == ref.shape
    off, scale = j_detector._wire_affine(11, j_detector._wire_coord_scale(
        1000))
    want = np.asarray(jnp.clip(jnp.round((jnp.asarray(ref.numpy()) + off)
                                         * scale), 0.0, 65535.0
                               ).astype(jnp.uint16))
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(
        t_detector._pack_wire(ref, 1000).numpy(), want)
    ref = ref.numpy()
    valid = ref[..., 10] > 0.5
    assert valid.sum() >= 4
    got = t_detector._unpack_wire(packed, 1000)
    np.testing.assert_array_equal(
        got, j_detector._unpack_wire(packed, 1000))
    np.testing.assert_array_equal(got[..., 10], ref[..., 10])
    np.testing.assert_allclose(got[..., :9][valid], ref[..., :9][valid],
                               rtol=0, atol=1.0 / 32 + 1e-6)
    np.testing.assert_allclose(got[..., 9][valid], ref[..., 9][valid],
                               rtol=0, atol=1.0 / 32768 + 1e-7)
    # The pack itself on chosen values: half to even, clip, both scales.
    block = torch.zeros((1, 4, 11))
    block[0, :, 0] = torch.tensor([-1024.5, 3.03125, 3.09375, 5000.0])
    block[0, :, 9] = torch.tensor([0.5, 1.0, 2.0, 5.0])
    for side in (1000, 4096):
        p = t_detector._pack_wire(block, side).numpy()
        off, scale = j_detector._wire_affine(
            11, j_detector._wire_coord_scale(side))
        want = np.clip(np.round((block.numpy() + off) * scale), 0,
                       65535).astype(np.uint16)
        np.testing.assert_array_equal(p, want)
    assert t_detector._wire_coord_scale(3071) == 16.0
    assert t_detector._wire_coord_scale(3072) == 8.0
    p = t_detector._pack_wire(block, 1000).numpy()[0, :, 0]
    assert list(p) == [0, 16432, 16434, 65535]       # 16432.5 -> even


def test_u16_wire_range_guards(models):
    """The u16 wire represents canvases up to 7167 px: a larger canvas
    raises at construction and where an oversized input grows the canvas;
    the f32 wire has no such limit."""
    _, tm = models
    big = dataclasses.replace(TConfig(**SMALL), prescale_size=7680)
    with pytest.raises(ValueError, match="u16"):
        t_detector.FaceDetector(tm, big, device="cpu")
    t_detector.FaceDetector(
        tm, dataclasses.replace(big, wire_format="f32"), device="cpu")
    t_detector.FaceDetector(
        tm, dataclasses.replace(big, prescale_size=7167), device="cpu")
    det = t_detector.FaceDetector(
        tm, dataclasses.replace(TConfig(**SMALL), image_prescaling=False),
        device="cpu")
    assert det._fit_canvas(100, 2500) == (2560, 2560)      # grows, in range
    with pytest.raises(ValueError, match="u16"):
        det._fit_canvas(7200, 64)
    assert det._canvas_hw == (2560, 2560)
    det_f32 = t_detector.FaceDetector(
        tm, dataclasses.replace(TConfig(**SMALL), image_prescaling=False,
                                wire_format="f32"), device="cpu")
    assert det_f32._fit_canvas(7200, 64) == (7680, 7680)


def test_data_mesh_detect_matches_unsharded(models):
    """``FaceDetector(data_mesh=2, device="cpu")`` gives ``detect`` the
    results of ``data_mesh=0``, the window batch sharded over two CPU
    copies."""
    _, tm = models
    img = _images(1, 1)[0]
    det = t_detector.FaceDetector(tm, TConfig(data_mesh=2, **SMALL),
                                  device="cpu")
    assert len(det._mesh.axis_devices("data")) == 2
    want = t_detector.FaceDetector(tm, TConfig(**SMALL),
                                   device="cpu").detect(img)
    assert want
    _assert_same_lists([det.detect(img)], [want], px_tol=SELF_TOL["atol"])


def test_batch_entry_points_default_to_cuda(models):
    """No silent CPU fallback in the batch and stream entry points."""
    _, tm = models
    if torch.cuda.is_available():
        assert t_detector.FaceDetector(
            tm, TConfig(**SMALL)).device.type == "cuda"
        tm.to("cpu")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_detector.FaceDetector(tm, TConfig(**SMALL))
