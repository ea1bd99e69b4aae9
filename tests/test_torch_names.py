"""PyTorch port vs the JAX package: public names of the JAX package that
the port copied last.

- ``DetectionModel.network_for(raw_type)`` on the shipped artifacts: the
  same network (by name and by weights) for every stage type;
- ``FaceDetector.prescale_factor(w, h)``: equal, prescaling on and off;
- ``HierarchicalNetwork.execute(x)``: equal to ``forward``, and to JAX's
  ``execute`` within the float32 tolerance of tests/test_torch_models.py
  (rtol 1e-5, atol 1e-5);
- the ``dtype=`` keyword of ``sfa_fit``, ``pca_fit``, ``igsfa_fit``,
  ``GaussianRegressor.create`` / ``.fit`` and ``RidgeRegressor.fit``:
  buffers of the asked type holding JAX's values. Both fit in float64
  numpy; float32 buffers are equal, bfloat16 ones within one bfloat16
  step (rtol 2**-7: either side may round float64 to bfloat16 through
  float32). float64, which JAX keeps as float32 without x64, holds the
  JAX package's float64 host solution itself.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.models import sfa as t_sfa
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor as TGauss
from pyfaceanalysis_torch.ops.ridge import RidgeRegressor as TRidge
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.engine import detector as j_detector
from pyfaceanalysis_tpu.models import builder
from pyfaceanalysis_tpu.models import sfa as j_sfa
from pyfaceanalysis_tpu.models.init import random_network_params
from pyfaceanalysis_tpu.ops.gaussian import GaussianRegressor as JGauss
from pyfaceanalysis_tpu.ops.ridge import RidgeRegressor as JRidge

ART = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "SavedNetworksTPU")
DTYPES = [(torch.float32, jnp.float32, 0.0),
          (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)]


@pytest.fixture(scope="module")
def shipped():
    return (j_detector.DetectionModel.load(ART),
            t_detector.DetectionModel.load(ART, device="cpu"))


def test_network_for_every_stage(shipped):
    jm, tm = shipped
    for st in jm.spec.stages:
        jnet = jm.network_for(st.raw_type)
        tnet = tm.network_for(st.raw_type)
        jname = [n for n, v in jm.nets.items() if v is jnet]
        tname = [n for n, v in tm.nets.items() if v is tnet]
        assert jname and set(jname) == set(tname), st.raw_type
        for jp, tp in zip(jnet.params, tnet.params):
            np.testing.assert_array_equal(tp.W.numpy(), np.asarray(jp.W))


@pytest.mark.parametrize("prescale", [True, False])
def test_prescale_factor(shipped, prescale):
    jm, tm = shipped
    kw = dict(image_prescaling=prescale, prescale_size=800)
    jd = j_detector.FaceDetector(jm, JConfig(**kw))
    td = t_detector.FaceDetector(tm, TConfig(**kw), device="cpu")
    for w, h in ((640, 480), (800, 800), (1600, 1200), (333, 2000)):
        assert td.prescale_factor(w, h) == jd.prescale_factor(w, h)


def test_execute_is_forward():
    jnet = random_network_params(builder.build_higsfa(16, d=4, top_dim=8),
                                 seed=3)
    tnet = t_art.from_jax_params([dict(
        field_indices=s.indices_array(), expansion=s.expansion.name,
        exponent=s.expansion.exponent, out_dim=s.out_dim, node=s.node,
        slow_dim=s.slow_dim, clip=s.clip, mean=np.asarray(p.mean),
        W=np.asarray(p.W)) for s, p in zip(jnet.specs, jnet.params)],
        input_hw=jnet.input_hw)
    x = np.random.RandomState(0).rand(12, 256).astype(np.float32)
    with torch.no_grad():
        got = tnet.execute(torch.from_numpy(x))
        assert torch.equal(got, tnet(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.execute(x)),
                               rtol=1e-5, atol=1e-5)


def _assert_buffers(tmod, jvalues, tdtype, rtol):
    for name, want in jvalues.items():
        got = getattr(tmod, name)
        assert got.dtype == tdtype, name
        want = np.asarray(want)
        assert str(want.dtype) == str(tdtype).split(".")[-1], name
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=rtol,
                                   atol=0, err_msg=name)


def _fit_data():
    rng = np.random.RandomState(5)
    lab = rng.rand(120)
    x = (np.outer(lab, rng.randn(2 * 6)) + 0.3 * rng.randn(120, 12)
         ).reshape(120, 2, 6)
    return x, lab


@pytest.mark.parametrize("tdtype,jdtype,rtol", DTYPES,
                         ids=["float32", "bfloat16"])
def test_sfa_fit_dtypes(tdtype, jdtype, rtol):
    x, lab = _fit_data()
    for tf, jf, args, kw in (
            (t_sfa.sfa_fit, j_sfa.sfa_fit, (3,),
             dict(graph="serial", labels=lab, num_groups=6)),
            (t_sfa.pca_fit, j_sfa.pca_fit, (3,), {}),
            (t_sfa.igsfa_fit, j_sfa.igsfa_fit, (2, 4),
             dict(graph="serial", labels=lab, num_groups=6))):
        jnode = jf(x, *args, dtype=jdtype, **kw)
        tnode = tf(x, *args, dtype=tdtype, **kw)
        _assert_buffers(tnode, {"mean": jnode.mean, "W": jnode.W}, tdtype,
                        rtol)


def test_sfa_fit_float64_holds_the_host_solution():
    x, lab = _fit_data()
    node = t_sfa.sfa_fit(x, 3, graph="serial", labels=lab, num_groups=6,
                         dtype=torch.float64)
    mean, B = j_sfa.covariance(x)
    A = j_sfa.serial_edge_scatter(x - mean, lab, 6)
    assert node.W.dtype == node.mean.dtype == torch.float64
    np.testing.assert_array_equal(node.mean.numpy(), mean)
    np.testing.assert_allclose(node.W.numpy(), j_sfa.solve_gsfa(A, B, 3),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tdtype,jdtype,rtol", DTYPES,
                         ids=["float32", "bfloat16"])
def test_regressor_dtypes(tdtype, jdtype, rtol):
    rng = np.random.RandomState(6)
    x = rng.randn(90, 4)
    cls = rng.randint(0, 3, 90)
    avg = np.array([1.0, 2.5, 4.0])
    fields = ("means", "inv_covs", "log_norm", "avg_labels")
    jclf = JGauss.fit(x, cls, avg_labels=avg, dtype=jdtype)
    _assert_buffers(TGauss.fit(x, cls, avg_labels=avg, dtype=tdtype),
                    {k: getattr(jclf, k) for k in fields}, tdtype, rtol)
    covs = np.stack([np.eye(4) * (1 + k) for k in range(3)])
    args = (rng.randn(3, 4), np.linalg.inv(covs),
            np.sqrt(np.linalg.det(covs)), np.full(3, 1 / 3), avg)
    jclf = JGauss.create(*args, dtype=jdtype)
    _assert_buffers(TGauss.create(*args, dtype=tdtype),
                    {k: getattr(jclf, k) for k in fields}, tdtype, rtol)
    y = x @ rng.randn(4) + 0.1 * rng.randn(90)
    jr = JRidge.fit(x, y, 3, dtype=jdtype)
    _assert_buffers(TRidge.fit(x, y, 3, dtype=tdtype),
                    {k: getattr(jr, k) for k in ("w", "b", "clip_lo",
                                                 "clip_hi", "resid_std")},
                    tdtype, rtol)
