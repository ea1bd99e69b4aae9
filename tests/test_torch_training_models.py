"""PyTorch port vs the JAX package: the training side of the model zoo.

Moments, device eigensolves, the host float64 fits, builders, random
initialization, Gaussian fits and ``train_network``, on the same numpy
inputs made from seeds. Tolerances:

- moments: rtol 1e-4 with an absolute floor of 1e-5 of the largest entry
  (float32 sums in another order);
- eigensolves: any two solvers may negate an eigenvector, so projected
  outputs are compared column by column up to sign, on data with a
  well-separated planted spectrum (atol 2e-3 on unit-variance outputs for
  the float32 device solvers, 1e-9 for the float64 host fits, which run the
  same numpy code on both sides);
- Gaussian fits: the float64 host fit is the same code, so the float32
  buffers and the regression agree within 1e-6;
- ``train_network``: features of the tiny net up to per-column sign within
  2e-3 of each column's largest magnitude, and the outputs of classifiers
  fitted on each side's features within 2e-3 in label units (label range
  1.9); readings on this data: 4.3e-4 and 5.8e-4 at most (float32 products
  in another order through five layers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_draws import fair_torch_threads  # noqa: F401 (autouse)

from pyfaceanalysis_torch.models import builder as t_builder
from pyfaceanalysis_torch.models import init as t_init
from pyfaceanalysis_torch.models import moments as t_mom
from pyfaceanalysis_torch.models import sfa as t_sfa
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor as TGauss
from pyfaceanalysis_torch.training import trainer as t_tr
from pyfaceanalysis_tpu.models import builder as j_builder
from pyfaceanalysis_tpu.models import moments as j_mom
from pyfaceanalysis_tpu.models import sfa as j_sfa
from pyfaceanalysis_tpu.ops.gaussian import GaussianRegressor as JGauss
from pyfaceanalysis_tpu.training import trainer as j_tr

SOLVER_ATOL = 2e-3
HOST_ATOL = 1e-9
GAUSS_ATOL = 1e-6
NET_ATOL = 2e-3



def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-5 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def assert_columns_up_to_sign(got, want, atol):
    """Each column of ``got`` equals the column of ``want`` or its
    negation within ``atol``; returns the largest difference."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    assert got.shape == want.shape
    worst = 0.0
    for c in range(want.shape[1]):
        d = min(np.abs(got[:, c] - want[:, c]).max(),
                np.abs(got[:, c] + want[:, c]).max())
        worst = max(worst, d)
        assert d <= atol, (c, d)
    return worst


def _planted(n=3000, fields=2, dim=8, seed=0, rank=None):
    """(n, fields, dim) mixtures of sources sin(k t) with distinct
    frequencies: a temporal graph sees a well-separated slowness spectrum.
    With ``rank`` < dim the mixture is rank deficient (the solvers' rank
    control must drop the null directions)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 4 * np.pi, n)
    k = rank or dim
    src = np.stack([np.sin((1 + 3.7 * j) * t) * (1 + 0.3 * j)
                    for j in range(k)], 1)
    # Orthonormal mixing keeps B well conditioned (every source above the
    # solvers' 1e-3 rank cut).
    x = np.stack([src @ np.linalg.qr(rng.randn(dim, k))[0].T
                  for _ in range(fields)], 1)
    return x.astype(np.float32), t


# --- moments -----------------------------------------------------------------

@pytest.fixture(scope="module")
def moment_data():
    rng = np.random.RandomState(1)
    x = (rng.randn(243, 3, 5) * [1.0, 2.0, 0.5, 3.0, 1.5]
         + rng.randn(3, 5)).astype(np.float32)
    labels = rng.uniform(-1, 1, (243, 3)).astype(np.float32)
    labels[::7, 0] = 0.25                       # ties: the stable sort
    cls = rng.choice([1, 5, 9, 12], 243)        # sparse class ids
    return x, labels, cls


def test_mean_cov_and_scatters(moment_data):
    x, labels, cls = moment_data
    jm, jc = j_mom.mean_cov(jnp.asarray(x))
    tm, tc = t_mom.mean_cov(_t(x))
    _close(tm, jm)
    _close(tc, jc)
    xc = x - np.asarray(jm)
    _close(t_mom.temporal_scatter(_t(xc)),
           j_mom.temporal_scatter(jnp.asarray(xc)))
    order = np.argsort(labels[:, 0], kind="stable")
    # 243 rows in 7 groups: the 5 tail rows are dropped.
    _close(t_mom.serial_scatter(_t(xc[order]), 7),
           j_mom.serial_scatter(jnp.asarray(xc[order]), 7))
    onehot = np.eye(4, dtype=np.float32)[np.unique(cls,
                                                   return_inverse=True)[1]]
    _close(t_mom.clustered_scatter(_t(xc), _t(onehot), 4),
           j_mom.clustered_scatter(jnp.asarray(xc), jnp.asarray(onehot), 4))


@pytest.mark.parametrize("case", ["temporal", "serial1", "serial3w",
                                  "clustered"])
def test_gsfa_moments(moment_data, case):
    x, labels, cls = moment_data
    kw = {"temporal": dict(graph="temporal"),
          "serial1": dict(graph="serial", labels=labels[:, 0],
                          num_groups=10),
          "serial3w": dict(graph="serial", labels=labels, num_groups=7,
                           label_weights=(2.0, 1.0, 1.0)),
          "clustered": dict(graph="clustered", labels=cls)}[case]
    jout = j_mom.gsfa_moments(jnp.asarray(x), **kw)
    tout = t_mom.gsfa_moments(_t(x), **kw)
    for got, want in zip(tout, jout):
        _close(got, want)


# --- device eigensolves ------------------------------------------------------

def _project(x, mean, W):
    return np.einsum("nfd,fdo->nfo", x - np.asarray(mean), np.asarray(W))


@pytest.mark.parametrize("rank", [None, 6])
def test_solve_gsfa_device(rank):
    x, t = _planted(rank=rank)
    mean, B, A = j_mom.gsfa_moments(jnp.asarray(x), "temporal")
    want = _project(x, mean, j_mom.solve_gsfa_device(A, B, 4))
    W = t_mom.solve_gsfa_device(_t(A), _t(B), 4)
    got = _project(x, mean, W.numpy())
    assert_columns_up_to_sign(got, want, SOLVER_ATOL)
    # whitened, decorrelated, slowest first (tests/test_models.py checks)
    y = got[:, 0, :]
    np.testing.assert_allclose(np.cov(y.T), np.eye(4), atol=0.02)
    slowness = (np.diff(got, axis=0) ** 2).mean(axis=0)[0]
    assert np.all(np.diff(slowness) > 0)
    assert abs(np.corrcoef(y[:, 0], np.sin(t))[0, 1]) > 0.98


def test_solve_pca_device():
    x, _ = _planted()
    _, B = j_mom.mean_cov(jnp.asarray(x))
    want = np.asarray(j_mom.solve_pca_device(B, 5))
    got = t_mom.solve_pca_device(_t(B), 5).numpy()
    for f in range(x.shape[1]):
        assert_columns_up_to_sign(got[f], want[f], 1e-4)


def test_solve_igsfa_device():
    x, t = _planted(n=4000, fields=1, dim=8, seed=7)
    mean, B, A = j_mom.gsfa_moments(jnp.asarray(x), "temporal")
    want = _project(x, mean, j_mom.solve_igsfa_device(A, B, 2, 6))
    W = t_mom.solve_igsfa_device(_t(A), _t(B), 2, 6)
    got = _project(x, mean, W.numpy())
    assert_columns_up_to_sign(got, want, SOLVER_ATOL)
    y = got[:, 0, :]
    assert abs(np.corrcoef(y[:, 0], np.sin(t))[0, 1]) > 0.95
    var = y.var(axis=0)
    assert np.all(var[2:] > 0.5) and np.all(var[2:] < 2.0)
    assert np.all(np.abs(np.corrcoef(y.T)[:2, 2:]) < 0.15)


# --- host float64 fits (models/sfa.py) ---------------------------------------

def test_host_scatters_and_solve():
    rng = np.random.RandomState(4)
    x = rng.randn(400, 2, 5).cumsum(axis=0)
    labels = rng.uniform(-1, 1, 400)
    cls = rng.randint(0, 3, 400)
    mean, cov = j_sfa.covariance(x)
    tmean, tcov = t_sfa.covariance(x)
    np.testing.assert_allclose(tmean, mean, rtol=0, atol=HOST_ATOL)
    np.testing.assert_allclose(tcov, cov, rtol=1e-12, atol=HOST_ATOL)
    xc = x - mean
    for jf, tf, args in (
            (j_sfa.temporal_edge_scatter, t_sfa.temporal_edge_scatter, ()),
            (j_sfa.serial_edge_scatter, t_sfa.serial_edge_scatter,
             (labels, 9)),
            (j_sfa.clustered_edge_scatter, t_sfa.clustered_edge_scatter,
             (cls,))):
        np.testing.assert_allclose(tf(xc, *args), jf(xc, *args),
                                   rtol=1e-12, atol=HOST_ATOL)
    A = j_sfa.temporal_edge_scatter(xc)
    np.testing.assert_allclose(
        np.abs(t_sfa.solve_gsfa(A, cov, 3)), np.abs(j_sfa.solve_gsfa(A, cov, 3)),
        rtol=1e-9, atol=HOST_ATOL)


@pytest.mark.parametrize("fit", ["sfa_temporal", "sfa_serial",
                                 "sfa_clustered", "pca", "igsfa"])
def test_host_fits(fit):
    x, t = _planted(n=2000, fields=2, dim=6, seed=3)
    rng = np.random.RandomState(5)
    labels = np.sin(t) + 0.05 * rng.randn(len(t))
    cls = (labels > 0).astype(int)
    args = {"sfa_temporal": ("sfa_fit", (x, 3), {}),
            "sfa_serial": ("sfa_fit", (x, 2), dict(graph="serial",
                                                    labels=labels,
                                                    num_groups=20)),
            "sfa_clustered": ("sfa_fit", (x, 1), dict(graph="clustered",
                                                       labels=cls)),
            "pca": ("pca_fit", (x, 3), {}),
            "igsfa": ("igsfa_fit", (x,), dict(slow_dim=2, out_dim=4))}[fit]
    jnode = getattr(j_sfa, args[0])(*args[1], **args[2])
    tnode = getattr(t_sfa, args[0])(*args[1], **args[2])
    np.testing.assert_array_equal(tnode.mean.numpy(), np.asarray(jnode.mean))
    want = np.asarray(jnode(jnp.asarray(x)))
    got = tnode(_t(x)).numpy()
    assert_columns_up_to_sign(got, want, 1e-4)


# --- builders and initialization ---------------------------------------------

BUILDS = [
    ("build_higsfa", (64,), {}),
    ("build_higsfa", (16,), dict(base_field=4, d=6, top_dim=8)),
    ("build_pca_net", (96,), {}),
    ("build_higsfa", (64,), dict(node="igsfa")),
    ("build_higsfa", (32,), dict(node="pca", expansion="identity",
                                 merge_expansion="qt4")),
    ("build_pca_net", (96,), dict(node="sfa")),
    ("build_pca_net", (48,), dict(node="igsfa", top_dim=12)),
]


@pytest.mark.parametrize("fn,args,kw", BUILDS)
def test_builders_equal(fn, args, kw):
    jnet = getattr(j_builder, fn)(*args, **kw)
    tnet = getattr(t_builder, fn)(*args, **kw)
    assert tnet.input_hw == tuple(jnet.input_hw)
    assert len(tnet.specs) == len(jnet.specs)
    for ts, js in zip(tnet.specs, jnet.specs):
        np.testing.assert_array_equal(ts.indices_array(), js.indices_array())
        assert ts.field_indices == js.field_indices
        assert dataclasses.asdict(ts.expansion) == dataclasses.asdict(
            js.expansion)
        assert (ts.out_dim, ts.node, ts.slow_dim, ts.clip) == (
            js.out_dim, js.node, js.slow_dim, js.clip)


def test_random_init():
    net = t_builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
    a = t_init.random_network_params(net, seed=3)
    b = t_init.random_network_params(net, seed=3)
    jnet = j_builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
    from pyfaceanalysis_tpu.models.init import random_network_params
    jref = random_network_params(jnet, seed=3)
    for pa, pb, pj in zip(a.params, b.params, jref.params):
        assert pa.W.shape == tuple(pj.W.shape)
        assert pa.mean.shape == tuple(pj.mean.shape)
        assert torch.equal(pa.W, pb.W)
        gram = torch.einsum("fdo,fdp->fop", pa.W, pa.W)
        assert torch.allclose(gram, torch.eye(pa.W.shape[-1]).expand_as(gram),
                              atol=1e-5)
    out = a(torch.rand(4, 256, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (4, 8) and torch.isfinite(out).all()
    clf = t_init.random_classifier(6, 4, -5.0, 5.0, seed=2)
    assert clf.means.shape == (4, 6)
    assert torch.equal(clf.means,
                       t_init.random_classifier(6, 4, -5.0, 5.0, 2).means)
    np.testing.assert_allclose(clf.avg_labels.numpy(),
                               np.linspace(-5, 5, 4))


# --- Gaussian fits -----------------------------------------------------------

def _gauss_equal(tclf, jclf, x):
    for k in ("means", "inv_covs", "log_norm", "avg_labels"):
        np.testing.assert_allclose(getattr(tclf, k).numpy(),
                                   np.asarray(getattr(jclf, k)), rtol=0,
                                   atol=GAUSS_ATOL * max(1.0, np.abs(
                                       np.asarray(getattr(jclf, k))).max()))
    want = np.asarray(jclf.regression(jnp.asarray(x[:, :jclf.input_dim])))
    got = tclf.regression(_t(x[:, :tclf.input_dim])).numpy()
    span = max(np.ptp(np.asarray(jclf.avg_labels)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_ATOL * span)


def test_gaussian_fits():
    rng = np.random.RandomState(8)
    x = rng.randn(900, 6) + np.linspace(0, 2, 6)
    v = x[:, 0] * 3 + 0.3 * rng.randn(900)
    cls = rng.choice([2, 4, 7], 900)
    x_new = rng.randn(50, 6)
    _gauss_equal(TGauss.fit(x, cls % 3, reg=1e-3),
                 JGauss.fit(x, cls % 3, reg=1e-3), x_new)
    _gauss_equal(t_tr.fit_regressor_bins(x, v, 4, 12),
                 j_tr.fit_regressor_bins(x, v, 4, 12), x_new)
    _gauss_equal(
        t_tr.fit_regressor_classes(x, cls, np.linspace(0, 1, 8), 5),
        j_tr.fit_regressor_classes(x, cls, np.linspace(0, 1, 8), 5), x_new)


# --- train_network on a tiny net ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_data():
    """(N, 256) 16x16 patches driven by one slow latent u: ten Legendre
    polynomials of u, each on its own random pixel pattern with a
    geometrically falling amplitude, plus faint pixel noise. Functions of
    one variable have a simple (non-degenerate) slowness spectrum under the
    temporal, serial and binned-class graphs, so every output column is
    well determined. Labels: three monotone functions of u; 14 classes."""
    from numpy.polynomial import legendre
    rng = np.random.RandomState(11)
    n, K = 720, 10
    u = 0.95 * np.sin(np.linspace(0, 3 * np.pi, n))
    polys = np.stack([legendre.legval(u, np.eye(K + 1)[k])
                      for k in range(1, K + 1)], 1)
    amp = 0.1 * 0.8 ** np.arange(K)
    img = (0.5 + np.einsum("nk,k,kij->nij", polys, amp,
                           rng.randn(K, 16, 16))
           + 0.005 * rng.randn(n, 16, 16))
    x = img.reshape(n, 256).astype(np.float32)
    lab = np.stack([u, u ** 3, np.tanh(2 * u)], 1) + 1e-3 * rng.randn(n, 3)
    cls = np.digitize(u, np.linspace(-0.95, 0.95, 16)[1:-1])
    return x, lab.astype(np.float32), cls


# Every graph with the sfa node, the igsfa node on both label graphs, and
# the pca node (which ignores the graph).
CASES = [("sfa", "temporal"), ("sfa", "serial"), ("sfa", "clustered"),
         ("igsfa", "serial"), ("igsfa", "clustered"), ("pca", "temporal")]


@pytest.mark.parametrize("node,graph", CASES)
def test_train_network_tiny(tiny_data, node, graph):
    x, lab, cls = tiny_data
    kw = {"temporal": {}, "clustered": dict(labels=cls),
          "serial": dict(labels=lab, num_groups=40,
                         label_weights=(2.0, 1.0, 1.0))}[graph]
    jnet = j_builder.build_higsfa(16, base_field=4, d=6, top_dim=8,
                                  node=node)
    tnet = t_builder.build_higsfa(16, base_field=4, d=6, top_dim=8,
                                  node=node)
    jnet = j_tr.train_network(jnet, x, graph=graph, verbose=False, **kw)
    tnet = t_tr.train_network(tnet, torch.as_tensor(x), graph=graph,
                              verbose=False, **kw)
    assert next(tnet.buffers()).device.type == "cpu"
    want = j_tr._execute(jnet, x)
    got = t_tr._execute(tnet, torch.as_tensor(x))
    scale = np.abs(want).max(axis=0)
    assert_columns_up_to_sign(got / scale, want / scale, NET_ATOL)
    jclf = j_tr.fit_regressor_bins(want, lab[:, 0], 6, 10)
    tclf = t_tr.fit_regressor_bins(got, lab[:, 0], 6, 10)
    jreg = np.asarray(jclf.regression(jnp.asarray(want[:, :6])))
    treg = tclf.regression(torch.as_tensor(got[:, :6])).numpy()
    np.testing.assert_allclose(treg, jreg, rtol=0, atol=NET_ATOL)
