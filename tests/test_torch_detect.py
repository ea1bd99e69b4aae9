"""PyTorch port vs the JAX package: cascade, eyes, NMS and detect().

Both sides run on the CPU at ``matmul_dtype="f32"`` (XLA's CPU compiler
may drop the bf16 operand rounding inside a jitted program, so bf16 runs
of the two packages do not compare). Detections agree within 1e-4: the
networks agree to ~1e-5 (tests/test_torch_models.py), and the boxes move
by regression outputs scaled to pixels.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_detector import random_artifact_dir  # noqa: F401  (fixture)
from test_engine import _const_classifier, _identity_net
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.config import resolve_device
from pyfaceanalysis_torch.engine import cascade as t_cascade
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.engine import eyes as t_eyes
from pyfaceanalysis_torch.engine import nms as t_nms
from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.io.writers import write_detections as t_write
from pyfaceanalysis_torch.parallel import dryrun as t_dryrun
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.config import NetGeometry
from pyfaceanalysis_tpu.engine import cascade as j_cascade
from pyfaceanalysis_tpu.engine import detector as j_detector
from pyfaceanalysis_tpu.engine import eyes as j_eyes
from pyfaceanalysis_tpu.engine import nms as j_nms
from pyfaceanalysis_tpu.io.writers import write_detections as j_write
from pyfaceanalysis_tpu.ops.pyramid import build_pyramid as j_pyramid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "SavedNetworksTPU")
TOL = dict(rtol=0, atol=1e-4)


def _scene(seed=3, hw=(200, 240)):
    """A rendered face (the JAX package's own renderer) on a background."""
    import jax

    from pyfaceanalysis_tpu.training import synth
    img, _ = synth.render_face(jax.random.PRNGKey(seed), canvas_hw=hw,
                               face_size=70.0, angle_deg=8.0)
    return np.asarray(img, np.float32)


def _rows(dets):
    return np.asarray([(*d.box, d.angle, *d.eye_left, *d.eye_right,
                        d.confidence) for d in dets], np.float64).reshape(-1,
                                                                         10)


@pytest.fixture(scope="module")
def shipped_models():
    return (j_detector.DetectionModel.load(ART),
            t_detector.DetectionModel.load(ART, device="cpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """The port's sources and chip_smoke.py import torch, never jax or
    pyfaceanalysis_tpu."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pyfaceanalysis_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pyfaceanalysis_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert {"heads.py", "normalization.py", "ridge.py", "images.py"} <= {
        os.path.basename(f) for f in files}
    for path in files:
        with open(path) as f:
            bad = [ln for ln in f if pat.match(ln)]
        assert not bad, (path, bad)


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_detector.DetectionModel.load(ART)
    # The dry run, as a function and as a command, builds its mesh on the
    # cards unless asked for the CPU.
    with pytest.raises(RuntimeError, match="asked for 1 CUDA devices"):
        t_dryrun.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="asked for 2 CUDA devices"):
        t_dryrun.main(["2"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_plan_and_calibration_match_jax(shipped_models):
    jm, tm = shipped_models
    assert tuple(tuple(p) for p in tm.plan) == tuple(tuple(p)
                                                     for p in jm.plan)
    assert tm.det_net_names == jm.det_net_names
    jd = j_detector.FaceDetector(jm, JConfig())
    td = t_detector.FaceDetector(tm, TConfig(), device="cpu")
    for f in dataclasses.fields(JConfig):
        assert getattr(td.config, f.name) == getattr(jd.config, f.name), \
            f.name


@pytest.mark.parametrize("hw", [(200, 240), (120, 140)])
def test_grid_state_matches_jax(hw):
    geom = NetGeometry()
    js, jn, jp = j_cascade.make_grid_state(hw[1], hw[0], geom, JConfig())
    ts, tn, tp = t_cascade.make_grid_state(hw[1], hw[0], geom, TConfig())
    assert jn == tn and jp.scales == tp.scales and jp.level_hw == tp.level_hw
    np.testing.assert_array_equal(tp.crops.numpy(), np.asarray(jp.crops))
    assert ts.img_idx is None and js.img_idx is None     # one image
    for a, b in zip(ts[:9], js[:9]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _cascade_inputs(jm, tm, img, cfg_kw):
    jcfg = j_detector.FaceDetector(jm, JConfig(**cfg_kw)).config
    tcfg = t_detector.FaceDetector(tm, TConfig(**cfg_kw),
                                   device="cpu").config
    h, w = img.shape
    js, _, jp = j_cascade.make_grid_state(w, h, jm.spec.face_geom, jcfg)
    ts, _, tp = t_cascade.make_grid_state(w, h, tm.spec.face_geom, tcfg)
    jpyr = j_pyramid(jnp.asarray(img), jp.scales, jp.level_hw)
    tpyr = torch.from_numpy(np.asarray(jpyr))
    return (jcfg, js, jpyr, jp), (tcfg, ts, tpyr, tp)


def _identity_port(specs, params):
    return t_art.from_jax_params([dict(
        field_indices=specs[0].indices_array(), expansion="identity",
        out_dim=specs[0].out_dim, clip=specs[0].clip,
        mean=np.asarray(params[0].mean), W=np.asarray(params[0].W))],
        input_hw=(64, 64))


def _port_classifier(jclf):
    return t_art.from_jax_params(gaussian={
        k: np.asarray(getattr(jclf, k)) for k in ("means", "inv_covs",
                                                  "log_norm", "avg_labels")})


# One regression value per stage kind: the boxes move, turn and grow, and
# the drift / angle / scale gates kill the windows of some grid scales.
_STAGE_VALUES = {"Disc": 0.3, "PosX": 3.0, "PosY": -2.0, "PAng": 8.0,
                 "Scale": 0.75}


@pytest.mark.parametrize("collect_trace", [False, True])
def test_run_cascade_matches_jax_canvas_path(shipped_models, collect_trace):
    """run_cascade with pallas_refine="off" (iter-0 pyramid crops, canvas
    gather afterwards) over the shipped 17-stage plan and grid, both
    compaction rungs (ties in the ranking included: every window has the
    same confidence, so only a stable sort keeps the JAX order).

    The networks are identity maps and the classifiers constants, so both
    sides do the same float operations: the update rules, gates,
    compaction and trace must agree within 1e-4. With trained networks,
    f32 GEMM rounding (~1e-5 relative, tests/test_torch_models.py) moves a
    box by ~1e-4 px, and the next nearest-neighbour extraction turns that
    into whole-texel differences; those are held end to end below and in
    test_first_disc_gate_matches_jax_shipped."""
    jm, tm = shipped_models
    img = _scene()
    kw = dict(matmul_dtype="f32", pallas_refine="off", mid_compact=64,
              mid_compact2=32, cut_offs_face=(0.9,) * 10,
              last_cut_off_face=0.9)
    (jcfg, js, jpyr, jp), (tcfg, ts, tpyr, tp) = _cascade_inputs(
        jm, tm, img, kw)
    geom = jm.spec.face_geom
    specs, params = _identity_net()
    jplan = tuple(p._replace(net_idx=min(p.net_idx, 0), input_dim=4)
                  for p in jm.plan)
    tplan = tuple(t_cascade.StagePlan(*p) for p in jplan)
    jclfs = tuple(_const_classifier(_STAGE_VALUES[p.kind]) for p in jplan)
    jout = j_cascade.run_cascade(
        jplan, (specs,), geom, jcfg, (64, 64), jnp.asarray(img),
        ((params[0],),), jclfs, js, pyramid=jpyr, crops=jp.crops,
        pyr_scales=jnp.asarray(jp.scales, jnp.float32),
        collect_trace=collect_trace)
    tout = t_cascade.run_cascade(
        tplan, (_identity_port(specs, params),), geom, tcfg, (64, 64),
        torch.from_numpy(img), tuple(_port_classifier(c) for c in jclfs),
        ts, pyramid=tpyr, crops=tp.crops, pyr_scales=torch.tensor(tp.scales),
        collect_trace=collect_trace)
    if collect_trace:
        (jout, jtrace), (tout, ttrace) = jout, tout
        assert len(ttrace) == len(jtrace) == 17
        for js_, ts_ in zip(jtrace, ttrace):
            np.testing.assert_array_equal(ts_[2].numpy(), np.asarray(js_[2]))
            for a, b in zip(ts_, js_):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tout.mask.shape[0] == (512 if collect_trace else 32)
    alive = np.asarray(jout.mask)
    assert alive.any()
    if collect_trace:           # the scale gate killed part of the grid
        assert alive.sum() < np.asarray(js.mask).sum()
    for a, b in zip(tout[:9], jout[:9]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_first_disc_gate_matches_jax_shipped(shipped_models):
    """The shipped networks and classifiers on the iter-0 pyramid crops of
    a rendered scene: the first Disc gate's confidences agree within 1e-5
    and the same windows pass it."""
    jm, tm = shipped_models
    img = _scene()
    kw = dict(matmul_dtype="f32", pallas_refine="off")
    (jcfg, js, jpyr, jp), (tcfg, ts, tpyr, tp) = _cascade_inputs(
        jm, tm, img, kw)
    geom = jm.spec.face_geom
    _, jtrace = j_cascade.run_cascade(
        jm.plan[:1], jm.det_specs, geom, jcfg, (64, 64), jnp.asarray(img),
        jm.det_params, jm.det_clfs, js, pyramid=jpyr, crops=jp.crops,
        pyr_scales=jnp.asarray(jp.scales, jnp.float32), collect_trace=True)
    _, ttrace = t_cascade.run_cascade(
        tm.plan[:1], tm.det_nets, geom, tcfg, (64, 64), torch.from_numpy(img),
        tm.det_clfs, ts, pyramid=tpyr, crops=tp.crops,
        pyr_scales=torch.tensor(tp.scales), collect_trace=True)
    (_, _, jmask, jconf), (_, _, tmask, tconf) = jtrace[0], ttrace[0]
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert 0 < int(tmask.sum()) < int(ts.mask.sum())
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-5)


def test_run_cascade_ref_matches_jax_interpret():
    """pallas_refine="ref" (plain level-space versions) vs the JAX
    "interpret" path (Pallas kernels in interpret mode), and vs the port's
    own canvas path, on a unit-scale level where both samplings coincide
    (the JAX suite's plumbing test, tests/test_pallas.py)."""
    geom = NetGeometry()
    rng = np.random.RandomState(7)
    img = rng.rand(160, 160).astype(np.float32)
    jpyr = j_pyramid(jnp.asarray(img), (1.0,), (160, 256))
    specs, params = _identity_net()
    tnet = _identity_port(specs, params)
    jclfs = (_const_classifier(0.5), _const_classifier(0.0),
             _const_classifier(0.5))
    tclfs = tuple(_port_classifier(c) for c in jclfs)
    plan = (j_cascade.StagePlan("Disc", 0, True, 0, 0, 4),
            j_cascade.StagePlan("PosX", 0, False, -1, 1, 4),
            j_cascade.StagePlan("Disc", 1, True, 0, 2, 4))
    tplan = tuple(t_cascade.StagePlan(*p) for p in plan)
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
    jstate = j_cascade.CascadeState(**{k: jnp.asarray(v)
                                       for k, v in st.items()})
    tstate = t_cascade.CascadeState(**{k: torch.from_numpy(np.asarray(v))
                                       for k, v in st.items()})
    jcfg = JConfig(bucket_sizes=(n,), mid_compact=0, pallas_refine="interpret")
    jout = j_cascade.run_cascade(plan, (specs,), geom, jcfg, (64, 64),
                                 jnp.asarray(img), ((params[0],),), jclfs,
                                 jstate, pyramid=jpyr,
                                 crops=jnp.asarray(crops),
                                 pyr_scales=jnp.ones((1,)))
    touts = {}
    for mode in ("ref", "on", "off"):
        touts[mode] = t_cascade.run_cascade(
            tplan, (tnet,), geom,
            TConfig(bucket_sizes=(n,), mid_compact=0, pallas_refine=mode),
            (64, 64), torch.from_numpy(img), tclfs, tstate,
            pyramid=torch.from_numpy(np.asarray(jpyr)),
            crops=torch.from_numpy(crops), pyr_scales=torch.ones(1))
    for a, b in zip(touts["ref"][:9], jout[:9]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=6e-3)
    for mode in ("on", "off"):
        for a, b in zip(touts[mode][:9], touts["ref"][:9]):
            assert torch.equal(a, b)


def _detect_both(jm, tm, img, **kw):
    jd = j_detector.FaceDetector(jm, JConfig(wire_format="f32",
                                             matmul_dtype="f32", **kw))
    td = t_detector.FaceDetector(tm, TConfig(matmul_dtype="f32", **kw),
                                 device="cpu")
    jr = _rows(jd.detect(img, estimate_attributes=False))
    tr = _rows(td.detect(img, estimate_attributes=False))
    assert td.windows_scanned == jd.windows_scanned > 0
    return jr, tr, jd, td


def test_localize_eyes_matches_jax(shipped_models):
    """One eye pass (canvas gather, shipped eye network) on identical eye
    boxes: the new boxes agree within 1e-4 px and the too-far magnitude
    (a regression in [-10, 10]) within 5e-4; the f32 GEMMs of the two
    frameworks differ by ~1e-5 relative, and the Gaussian soft regression
    amplifies that up to ~5e-5 (measured: 9e-5 px, 2.2e-4)."""
    jm, tm = shipped_models
    img = _scene()
    rng = np.random.RandomState(4)
    n = 12
    side = rng.uniform(12.0, 60.0, n)
    x0, y0 = rng.uniform(-10.0, 200.0, n), rng.uniform(-10.0, 160.0, n)
    boxes = np.stack([x0, y0, x0 + side, y0 + side], 1).astype(np.float32)
    angles = rng.uniform(-24.0, 24.0, n).astype(np.float32)
    hw = (jm.spec.eye_geom.subimage_height, jm.spec.eye_geom.subimage_width)
    jnet = jm.nets[jm.spec.stages[jm.stage("EyeLX")].network_name]
    jb, jreg = j_eyes.localize_eyes(
        jnet.specs, jm.clf_input_dim("EyeLX"), jm.clf_input_dim("EyeLY"), hw,
        jnp.asarray(img), tuple(jnet.params), jm.classifier("EyeLX"),
        jm.classifier("EyeLY"), jnp.asarray(boxes), jnp.asarray(angles))
    tb, treg = t_eyes.localize_eyes(
        tm.nets["net_eye"], tm.clf_input_dim("EyeLX"),
        tm.clf_input_dim("EyeLY"), hw, torch.from_numpy(img),
        tm.classifier("EyeLX"), tm.classifier("EyeLY"),
        torch.from_numpy(boxes), torch.from_numpy(angles))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), rtol=0,
                               atol=5e-4)


def test_detect_matches_jax_shipped_artifacts(shipped_models):
    """End to end on a 200x240 rendered scene with SavedNetworksTPU/."""
    jm, tm = shipped_models
    jr, tr, _, _ = _detect_both(jm, tm, _scene())
    assert jr.shape == tr.shape and len(jr) >= 1
    np.testing.assert_allclose(tr, jr, **TOL)


@pytest.mark.parametrize("kw", [
    dict(cut_offs_face=(1.01,) * 10),
    dict(cut_offs_face=(1.01,) * 10, eye_iters=2, mid_compact=128,
         mid_compact2=64),
], ids=["keep_all", "eye_iters2"])
def test_detect_matches_jax_random_artifacts(random_artifact_dir, kw):  # noqa: F811
    """End to end on the JAX suite's random-weight 32x32 artifacts (small
    widths; every stage and both compaction rungs), with the trace.

    Boxes, angles and confidences agree within 1e-4. The eye columns get
    5e-3 px: the eye boxes inherit the boxes' ~1e-5 px f32 differences,
    one nearest-neighbour eye sample then lands on the other texel, and
    the random-weight eye network turns that texel into ~2e-3 px (the JAX
    function alone moves as much for such a shift; on identical inputs the
    two eye passes agree within 1e-6, test_localize_eyes_matches_jax)."""
    jm = j_detector.DetectionModel.load(random_artifact_dir)
    tm = t_detector.DetectionModel.load(random_artifact_dir, device="cpu")
    img = np.random.RandomState(2).rand(120, 140).astype(np.float32)
    kw = dict(smallest_face=0.4, bucket_sizes=(256, 1024, 4096), **kw)
    jr, tr, jd, td = _detect_both(jm, tm, img, **kw)
    assert jr.shape == tr.shape
    eyes = np.zeros(10, bool)
    eyes[5:9] = True
    np.testing.assert_allclose(tr[:, ~eyes], jr[:, ~eyes], **TOL)
    np.testing.assert_allclose(tr[:, eyes], jr[:, eyes], rtol=0, atol=5e-3)
    j_trace = j_detector.FaceDetector(
        jm, JConfig(matmul_dtype="f32", **kw))
    j_trace.detect(img, estimate_attributes=False, collect_trace=True)
    td.detect(img, estimate_attributes=False, collect_trace=True)
    assert len(td.last_trace) == len(j_trace.last_trace) == 17
    for ts_, js_ in zip(td.last_trace, j_trace.last_trace):
        np.testing.assert_array_equal(ts_[2], js_[2])
        np.testing.assert_allclose(ts_[0][js_[2]], js_[0][js_[2]], **TOL)


def test_kernel_route_on_cpu_equals_ref_route(shipped_models):
    """pallas_refine="on" on CPU tensors goes through the kernel wrappers,
    which hand CPU tensors to the plain versions: the same detections as
    "ref"; and the level-space routes find the face the canvas route
    finds."""
    _, tm = shipped_models
    img = _scene()
    out = {}
    for mode in ("on", "ref", "off"):
        d = t_detector.FaceDetector(tm, TConfig(pallas_refine=mode),
                                    device="cpu")
        out[mode] = _rows(d.detect(img, estimate_attributes=False))
    np.testing.assert_array_equal(out["on"], out["ref"])
    assert len(out["ref"]) >= 1 and len(out["off"]) >= 1
    np.testing.assert_allclose(out["ref"][0, :4], out["off"][0, :4], atol=3.0)


def test_nms_and_writer_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    base = rng.uniform(20, 300, (12, 1))
    rows = np.concatenate([base + rng.uniform(0, 3, (12, 4)) * [1, 1, 60, 60],
                           rng.uniform(-5, 5, (12, 1)),
                           base + rng.uniform(0, 40, (12, 4)),
                           rng.uniform(0, 0.3, (12, 1))], axis=1)
    rows[3] = rows[2]                             # exact duplicate: a tie
    want = j_nms.purge_detections(rows, 0.25)
    got = t_nms.purge_detections(rows, 0.25)
    np.testing.assert_array_equal(got, want)
    dets = [t_detector.Detection(box=tuple(r[0:4]), angle=float(r[4]),
                                 eye_left=tuple(r[5:7]),
                                 eye_right=tuple(r[7:9]),
                                 confidence=float(r[9])) for r in got]
    jdets = [j_detector.Detection(box=d.box, angle=d.angle,
                                  eye_left=d.eye_left, eye_right=d.eye_right,
                                  confidence=d.confidence) for d in dets]
    dets[0].age, jdets[0].age = 31.5, 31.5
    dets[0].race_value, jdets[0].race_value = 1.2, 1.2
    dets[0].gender_value, jdets[0].gender_value = -0.3, -0.3
    for flip in (False, True):
        t_write(str(tmp_path / f"t{flip}.txt"), dets, flip)
        j_write(str(tmp_path / f"j{flip}.txt"), jdets, flip)
        assert (tmp_path / f"t{flip}.txt").read_text() == \
            (tmp_path / f"j{flip}.txt").read_text()

