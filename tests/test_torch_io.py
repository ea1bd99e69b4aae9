"""PyTorch port vs the JAX package: geometry helpers, text formats,
artifact writers and the legacy classifier converter.

Host text formats are exact; artifact directories written by one package
load in the other with exactly the same arrays; geometry agrees within
1e-6 (the same float32 operations in the same order).
"""

import json
import os
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch import geometry as t_geometry
from pyfaceanalysis_torch.config import NetGeometry as TGeometry
from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.io import legacy as t_legacy
from pyfaceanalysis_torch.io import pipeline as t_pipeline
from pyfaceanalysis_torch.io import writers as t_writers
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor as TGaussian
from pyfaceanalysis_tpu import geometry as j_geometry
from pyfaceanalysis_tpu.config import NetGeometry as JGeometry
from pyfaceanalysis_tpu.io import artifacts as j_art
from pyfaceanalysis_tpu.io import legacy as j_legacy
from pyfaceanalysis_tpu.io import pipeline as j_pipeline
from pyfaceanalysis_tpu.io import writers as j_writers
from pyfaceanalysis_tpu.models import builder
from pyfaceanalysis_tpu.models.init import random_network_params
from pyfaceanalysis_tpu.ops.gaussian import GaussianRegressor as JGaussian
from pyfaceanalysis_tpu.ops.ridge import RidgeRegressor as JRidge

GEOM_TOL = dict(rtol=0, atol=1e-6)


def _boxes(seed, n=40):
    rng = np.random.RandomState(seed)
    x0y0 = rng.uniform(0, 5, (n, 2))
    wh = rng.uniform(0.5, 3, (n, 2))
    return np.concatenate([x0y0, x0y0 + wh], axis=1).astype(np.float32)


def _eyes(seed, n=40):
    rng = np.random.RandomState(seed)
    left = rng.uniform(0, 5, (n, 2))
    right = left + rng.uniform(0.5, 2, (n, 2)) * [1, 0.2]
    return np.concatenate([left, right], axis=1).astype(np.float32)


# -- geometry ----------------------------------------------------------------

_GEOMETRY_CASES = {
    "compute_approximate_eye_coordinates": lambda g: g(_boxes(0)),
    "compute_face_midpoint": lambda g: np.stack(
        [np.asarray(v) for v in g(*(_to(g, _eyes(1)[:, k]) for k in range(4)),
                                  _to(g, _boxes(2)[:, 0]),
                                  _to(g, _boxes(2)[:, 1]))]),
    "compute_approximate_mouth_coordinates": lambda g: g(_eyes(3)),
    "relative_error_detection": lambda g: g(_eyes(4), _eyes(5)),
    "face_detected": lambda g: g(_eyes(6), _eyes(6) + np.float32(0.3)),
    "pairwise_relative_eye_error": lambda g: g(_eyes(7, 9), _eyes(8, 13)),
}


def _to(fn, a):
    """``a`` as the array type of the package ``fn`` belongs to."""
    return (torch.as_tensor(a) if fn.__module__.startswith(
        "pyfaceanalysis_torch") else jnp.asarray(a))


@pytest.mark.parametrize("name", sorted(_GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    case = _GEOMETRY_CASES[name]
    got = np.asarray(case(getattr(t_geometry, name)))
    want = np.asarray(case(getattr(j_geometry, name)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool:
        assert got.any() and not got.all()
        np.testing.assert_array_equal(got, want)
    else:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GEOM_TOL)


def test_geometry_keeps_the_tensor_device_and_takes_arrays():
    out = t_geometry.compute_approximate_eye_coordinates(
        torch.as_tensor(_boxes(0)))
    assert out.device.type == "cpu" and out.shape == (40, 4)
    assert t_geometry.pairwise_relative_eye_error(
        _eyes(1, 3).tolist(), _eyes(2, 5).tolist()).shape == (3, 5)


# -- text formats --------------------------------------------------------------

def test_read_batch_file_matches_jax(tmp_path):
    p = tmp_path / "batch.txt"
    p.write_text("a.jpg \nout_a.txt\r\nb c.jpg\nout_b.txt\ndangling.jpg\n")
    got = t_writers.read_batch_file(str(p))
    assert got == j_writers.read_batch_file(str(p))
    assert got == (["a.jpg", "b c.jpg"], ["out_a.txt", "out_b.txt"])


def test_load_true_coordinates_matches_jax(tmp_path):
    p = tmp_path / "coords.txt"
    p.write_text("img0.jpg\n100 50 137 50 118.5 92\n"
                 "\n"
                 "img1.jpg\n10.5, 20.25, 40, 22, 25, 30, 26, 45.5\n"
                 "img2.jpg\n1 2 3\n"                       # malformed: skipped
                 "img0.jpg\n200 60 230 66 215 80\n")
    for base in ("", "base"):
        t_files, t_rows = t_writers.load_true_coordinates(base, str(p))
        j_files, j_rows = j_writers.load_true_coordinates(base, str(p))
        assert t_files == j_files and len(t_files) == 3
        assert t_rows.shape == (3, 14)
        np.testing.assert_array_equal(t_rows, j_rows)
    assert t_files[1] == os.path.join("base", "img1.jpg")


def test_truth_row_from_landmarks_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        args = rng.uniform(10, 200, 8).tolist()
        assert (t_writers.truth_row_from_landmarks(*args)
                == j_writers.truth_row_from_landmarks(*args))


# -- artifacts -------------------------------------------------------------------

def _archive(path):
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    if "meta" in out:
        out["meta"] = json.loads(bytes(out["meta"]).decode())
    return out


def _assert_same_archive(a, b):
    za, zb = _archive(a), _archive(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        if k == "meta":
            assert za[k] == zb[k]
        else:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("kind", ["higsfa", "pca"])
def test_network_archives_cross_load(tmp_path, kind):
    """JAX saves -> port loads -> port saves -> JAX loads: every array and
    the layer metadata come back exactly, and both loaded networks compute
    the same features."""
    net = (builder.build_higsfa(16, base_field=4, d=4, top_dim=6)
           if kind == "higsfa" else
           builder.build_pca_net(24, base_field=6, d=4, top_dim=6))
    jnet = random_network_params(net, seed=3)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    j_art.save_network(a, jnet)
    tnet = t_art.load_network(a)
    t_art.save_network(b, tnet)
    _assert_same_archive(a, b)
    back = j_art.load_network(b)
    assert back.specs == jnet.specs and back.input_hw == jnet.input_hw
    side = jnet.input_hw[0]
    x = np.random.RandomState(0).rand(4, side * side).astype(np.float32)
    np.testing.assert_allclose(
        tnet(torch.as_tensor(x)).numpy(),
        np.asarray(back.execute(jnp.asarray(x))), rtol=0, atol=1e-5)


def _jax_classifier(head, rng):
    if head == "gaussian":
        return JGaussian.fit(rng.randn(300, 4), rng.randint(0, 3, 300),
                             avg_labels=np.array([1.0, 2.0, 3.0]))
    x = rng.randn(200, 6)
    return JRidge.fit(x, x[:, :4] @ [1.0, -2.0, 0.5, 3.0] + 0.1, 4)


@pytest.mark.parametrize("head", ["gaussian", "ridge"])
def test_classifier_archives_cross_load(tmp_path, head):
    rng = np.random.RandomState(0)
    jclf = _jax_classifier(head, rng)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    j_art.save_classifier(a, jclf, 4)
    tclf = t_art.load_classifier(a)
    t_art.save_classifier(b, tclf, 4)
    _assert_same_archive(a, b)
    back = j_art.load_classifier(b)
    assert type(back) is type(jclf)
    for got, want in zip(back, jclf):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    x = rng.randn(16, 4).astype(np.float32)
    for got, want in zip(tclf.regression(torch.as_tensor(x), True),
                         back.regression(jnp.asarray(x), True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="input_dim"):
        t_art.save_classifier(b, tclf, 5)


def _pipeline_spec(pipeline_mod, geom_cls):
    stages = tuple(pipeline_mod.StageSpec(t, n, c) for t, n, c in (
        ("Disc1", "net_disc", "clf_disc1"), ("PosX0", "net_pose", "clf_x0"),
        ("PosY0", "None0", "clf_y0"), ("EyeLX", "net_eye", "clf_elx"),
        ("EyeLY", "None0", "clf_ely"), ("Age", "net_age", "clf_age"),
        ("Race", "None0", "clf_race"), ("Gender", "None0", "clf_gender")))
    face = geom_cls(Dx=37.5, Dy=20, subimage_width=32, subimage_height=32)
    eye = geom_cls(Dx=8, Dy=8, Dang=0, mins=0.675, maxs=0.975,
                   regression_width=64, regression_height=64)
    age = geom_cls(Dx=0, Dy=0, Dang=0, mins=1.14, maxs=1.14,
                   subimage_width=96, subimage_height=96,
                   regression_width=160, regression_height=160)
    return pipeline_mod.PipelineSpec(face, eye, age, stages)


def test_pipeline_file_and_manifest_cross_load(tmp_path):
    """The pipeline text file and manifest.json written by either package
    are byte-equal and load in the other."""
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    jspec = _pipeline_spec(j_pipeline, JGeometry)
    tspec = _pipeline_spec(t_pipeline, TGeometry)
    calib = {"last_cut_off_face": 0.25, "pang_gain": 0.5,
             "cut_offs_face": [0.9] * 10}
    j_pipeline.write_pipeline(str(jd / "Pipeline_x.txt"), jspec)
    t_pipeline.write_pipeline(str(td / "Pipeline_x.txt"), tspec)
    j_art.save_manifest(str(jd), jspec.face_geom, jspec.eye_geom,
                        jspec.age_geom, calib)
    t_art.save_manifest(str(td), tspec.face_geom, tspec.eye_geom,
                        tspec.age_geom, calib)
    for name in ("Pipeline_x.txt", "manifest.json"):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    # Each package reads the other's directory.
    assert t_pipeline.parse_pipeline(str(jd / "Pipeline_x.txt")) == tspec
    assert j_pipeline.parse_pipeline(str(td / "Pipeline_x.txt")) == jspec
    assert t_art.load_manifest(str(jd)) == (tspec.face_geom, tspec.eye_geom,
                                            tspec.age_geom)
    assert j_art.load_manifest(str(td)) == (jspec.face_geom, jspec.eye_geom,
                                            jspec.age_geom)
    assert t_art.load_calibration(str(jd)) == calib
    assert j_art.load_calibration(str(td)) == calib
    t_art.save_manifest(str(td), tspec.face_geom, tspec.eye_geom,
                        tspec.age_geom)
    assert t_art.load_calibration(str(td)) == {}


# -- legacy pickles ----------------------------------------------------------------

def _write_legacy_pickle(path, seed=0, C=5, D=6):
    """A protocol-2 pickle of a ``GaussianClassifier`` whose module exists
    only while the pickle is written (as mdp does not exist when it is
    read), with the attribute schema of the reference's classifiers."""
    rng = np.random.RandomState(seed)
    covs = []
    for _ in range(C):
        a = rng.randn(D, D)
        covs.append(a @ a.T / D + 0.5 * np.eye(D))
    covs = np.stack(covs)
    priors = rng.dirichlet(np.ones(C))

    module = types.ModuleType("mdp_nodes_of_the_past")

    class GaussianClassifier(object):
        pass

    GaussianClassifier.__module__ = module.__name__
    GaussianClassifier.__qualname__ = "GaussianClassifier"
    module.GaussianClassifier = GaussianClassifier
    node = GaussianClassifier()
    node.means = [rng.randn(D) for _ in range(C)]        # a list of vectors
    node.inv_covs = np.linalg.inv(covs)
    node._sqrt_def_covs = np.sqrt(np.linalg.det(covs))
    node.p = priors
    node.labels = list(range(C))
    node.avg_labels = np.linspace(-20.0, 20.0, C)
    node._input_dim = D
    sys.modules[module.__name__] = module
    try:
        with open(path, "wb") as f:
            pickle.dump(node, f, protocol=2)
    finally:
        del sys.modules[module.__name__]
    return node


def test_legacy_pickle_converts_like_jax(tmp_path):
    path = str(tmp_path / "clf.pckl")
    node = _write_legacy_pickle(path)
    stub = t_legacy.load_legacy_pickle(path)
    assert type(stub).__module__ == "mdp_nodes_of_the_past"
    assert stub._input_dim == 6 and stub.labels == node.labels
    tclf = t_legacy.gaussian_regressor_from_legacy(path)
    jclf = j_legacy.gaussian_regressor_from_legacy(path)
    assert isinstance(tclf, TGaussian)
    assert (tclf.num_classes, tclf.input_dim) == (5, 6)
    for name in ("means", "inv_covs", "log_norm", "avg_labels"):
        got = getattr(tclf, name).numpy()
        want = np.asarray(getattr(jclf, name))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    x = (np.stack(node.means)[np.arange(12) % 5]
         + 0.3 * np.random.RandomState(1).randn(12, 6)).astype(np.float32)
    t_reg, t_std = tclf.regression(torch.as_tensor(x), estimate_std=True)
    j_reg, j_std = jclf.regression(jnp.asarray(x), estimate_std=True)
    np.testing.assert_allclose(t_reg.numpy(), np.asarray(j_reg), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_std.numpy(), np.asarray(j_std), rtol=0,
                               atol=1e-4)
    assert -20.0 <= t_reg.min() and t_reg.max() <= 20.0
    np.testing.assert_array_equal(tclf.classify(torch.as_tensor(x)).numpy(),
                                  np.asarray(jclf.classify(jnp.asarray(x))))
    assert len(set(tclf.classify(torch.as_tensor(x)).tolist())) > 1


def test_gaussian_create_matches_jax():
    rng = np.random.RandomState(2)
    C, D = 4, 3
    args = (rng.randn(C, D), rng.randn(C, D, D), rng.uniform(0.1, 9, C),
            rng.dirichlet(np.ones(C)), rng.randn(C))
    t, j = TGaussian.create(*args), JGaussian.create(*args)
    for name in ("means", "inv_covs", "log_norm", "avg_labels"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


def test_legacy_converter_rejects_another_schema(tmp_path):
    path = str(tmp_path / "bad.pckl")
    node = _write_legacy_pickle(path)
    node.inv_covs = node.inv_covs[:, :3]
    module = types.ModuleType("mdp_nodes_of_the_past")
    module.GaussianClassifier = type(node)
    sys.modules[module.__name__] = module
    try:
        with open(path, "wb") as f:
            pickle.dump(node, f, protocol=2)
    finally:
        del sys.modules[module.__name__]
    with pytest.raises(ValueError, match="unexpected classifier schema"):
        t_legacy.gaussian_regressor_from_legacy(path)
