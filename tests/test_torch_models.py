"""PyTorch port vs the JAX package: artifact loading and the HiGSFA forward.

Both packages load the same in-repo artifacts (``SavedNetworksTPU/``) or
get identical weights through ``io.artifacts.from_jax_params``; inputs are
made with numpy from a seed. Tolerances: float32 networks agree to rtol
1e-5 / atol 1e-5 (the two frameworks sum the products in another order);
with bf16 operands both round the same operands and accumulate in
float32, so they agree to atol 1e-4. The JAX side runs op by op (not under
``jit``), because XLA's CPU compiler may drop the f32->bf16->f32 operand
rounding inside a jitted program.
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.models.expansion import Expansion as TExpansion
from pyfaceanalysis_torch.models.network import apply_network as t_apply
from pyfaceanalysis_tpu.io import artifacts as j_art
from pyfaceanalysis_tpu.models import builder
from pyfaceanalysis_tpu.models.expansion import Expansion as JExpansion
from pyfaceanalysis_tpu.models.init import (
    random_classifier,
    random_network_params,
)
from pyfaceanalysis_tpu.models.network import apply_network as j_apply

ART = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "SavedNetworksTPU")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=1e-4)


def _jax_layers(net):
    return [dict(field_indices=spec.indices_array(),
                 expansion=spec.expansion.name,
                 exponent=spec.expansion.exponent, out_dim=spec.out_dim,
                 node=spec.node, slow_dim=spec.slow_dim, clip=spec.clip,
                 mean=np.asarray(node.mean), W=np.asarray(node.W))
            for spec, node in zip(net.specs, net.params)]


def _jax_gaussian(clf):
    return {k: np.asarray(getattr(clf, k))
            for k in ("means", "inv_covs", "log_norm", "avg_labels")}


def test_from_jax_params_round_trip():
    """A small random JAX network and classifier, converted through
    from_jax_params, carry identical arrays and compute the same outputs."""
    jnet = random_network_params(builder.build_higsfa(16, d=4, top_dim=8),
                                 seed=3)
    tnet = t_art.from_jax_params(_jax_layers(jnet), input_hw=jnet.input_hw)
    assert tnet.specs == tuple(
        t_art.from_jax_params(_jax_layers(jnet)).specs)
    for spec_j, spec_t, node_j, node_t, idx in zip(
            jnet.specs, tnet.specs, jnet.params, tnet.params, tnet.indices):
        assert spec_t.field_indices == spec_j.field_indices
        assert spec_t.expansion.name == spec_j.expansion.name
        assert (spec_t.out_dim, spec_t.clip) == (spec_j.out_dim, spec_j.clip)
        np.testing.assert_array_equal(node_t.mean.numpy(),
                                      np.asarray(node_j.mean))
        np.testing.assert_array_equal(node_t.W.numpy(), np.asarray(node_j.W))
        np.testing.assert_array_equal(idx.numpy(), spec_j.indices_array())
    x = np.random.RandomState(0).rand(12, 16 * 16).astype(np.float32)
    np.testing.assert_allclose(
        t_apply(tnet, torch.from_numpy(x)).numpy(),
        np.asarray(j_apply(jnet.specs, jnet.params, jnp.asarray(x))),
        **F32_TOL)

    jclf = random_classifier(6, 4, -5.0, 5.0, seed=2)
    tclf = t_art.from_jax_params(gaussian=_jax_gaussian(jclf))
    for k, v in _jax_gaussian(jclf).items():
        np.testing.assert_array_equal(getattr(tclf, k).numpy(), v)
    f = np.random.RandomState(1).randn(20, 6).astype(np.float32)
    np.testing.assert_allclose(
        tclf.regression(torch.from_numpy(f)).numpy(),
        np.asarray(jclf.regression(jnp.asarray(f))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        t_art.from_jax_params()


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ART, "*.npz"))),
                         ids=os.path.basename)
def test_shipped_artifact_equals_jax_loader(path):
    """Every array loaded from SavedNetworksTPU/ equals the JAX loader's."""
    if os.path.basename(path).startswith("net_"):
        j, t = j_art.load_network(path), t_art.load_network(path)
        assert t.input_hw == tuple(j.input_hw)
        assert len(t.specs) == len(j.specs)
        for sj, st, nj, nt, idx in zip(j.specs, t.specs, j.params,
                                       t.params, t.indices):
            assert st.field_indices == sj.field_indices
            assert (st.expansion.name, st.expansion.exponent) == (
                sj.expansion.name, sj.expansion.exponent)
            assert (st.out_dim, st.node, st.slow_dim, st.clip) == (
                sj.out_dim, sj.node, sj.slow_dim, sj.clip)
            np.testing.assert_array_equal(idx.numpy(), sj.indices_array())
            np.testing.assert_array_equal(nt.mean.numpy(),
                                          np.asarray(nj.mean))
            np.testing.assert_array_equal(nt.W.numpy(), np.asarray(nj.W))
    else:
        j, t = j_art.load_classifier(path), t_art.load_classifier(path)
        for k, v in _jax_gaussian(j).items():
            np.testing.assert_array_equal(getattr(t, k).numpy(), v)


def test_manifest_and_calibration_equal_jax():
    assert t_art.load_calibration(ART) == j_art.load_calibration(ART)
    for gt, gj in zip(t_art.load_manifest(ART), j_art.load_manifest(ART)):
        assert dataclasses.astuple(gt) == dataclasses.astuple(gj)


@pytest.mark.parametrize("name", ["identity", "spow", "qt8", "qt40"])
def test_expansion_matches_jax(name):
    x = np.random.RandomState(4).randn(5, 3, 12).astype(np.float32)
    want = np.asarray(JExpansion(name)(jnp.asarray(x)))
    got = TExpansion(name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert TExpansion(name).output_dim(12) == JExpansion(name).output_dim(12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["net_disc", "net_pose0", "net_eye",
                                  "net_disc_final"])
def test_apply_network_shipped(name, dtype):
    """The shipped networks on random rows, in both operand dtypes."""
    path = os.path.join(ART, name + ".npz")
    j, t = j_art.load_network(path), t_art.load_network(path)
    h, w = j.input_hw
    x = np.random.RandomState(5).rand(24, h * w).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else None
    td = torch.bfloat16 if dtype == "bf16" else None
    want = np.asarray(j_apply(j.specs, j.params, jnp.asarray(x),
                              compute_dtype=jd))
    got = t_apply(t, torch.from_numpy(x), compute_dtype=td).numpy()
    assert got.shape == want.shape == (24, j.out_dim)
    np.testing.assert_allclose(got, want,
                               **(BF16_TOL if dtype == "bf16" else F32_TOL))


@pytest.mark.parametrize("clf_name", ["clf_Disc1", "clf_PosX0", "clf_PAng1",
                                      "clf_Scale1", "clf_EyeLX", "clf_Disc9"])
def test_gaussian_regression_shipped(clf_name):
    """Regression (and its std) of the shipped classifiers on features
    drawn around their class means (the features the cascade feeds them
    lie there; far off the manifold the posteriors turn on the last bits
    of a large quadratic form, and the two frameworks sum it in another
    order)."""
    jc = j_art.load_classifier(os.path.join(ART, clf_name + ".npz"))
    tc = t_art.load_classifier(os.path.join(ART, clf_name + ".npz"))
    rng = np.random.RandomState(6)
    means = np.asarray(jc.means)
    pick = rng.randint(0, means.shape[0], 64)
    feats = (means[pick] + 0.5 * rng.randn(64, means.shape[1])
             ).astype(np.float32)
    want, want_std = jc.regression(jnp.asarray(feats), estimate_std=True)
    got, got_std = tc.regression(torch.from_numpy(feats), estimate_std=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_std.numpy(), np.asarray(want_std),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tc.posteriors(torch.from_numpy(feats)).numpy(),
        np.asarray(jc.posteriors(jnp.asarray(feats))), atol=1e-5)


def test_gaussian_far_off_manifold_stays_finite():
    """The 3e37 clamp and the -80 floor: huge inputs give the JAX answer
    (winner-take-all), never NaN."""
    jclf = random_classifier(4, 3, 0.0, 1.0, seed=7)
    tclf = t_art.from_jax_params(gaussian=_jax_gaussian(jclf))
    f = np.array([[1e20, -1e20, 1e20, 0.0], [0.0, 0.0, 0.0, 0.0]],
                 np.float32)
    got = tclf.regression(torch.from_numpy(f)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jclf.regression(
        jnp.asarray(f))), atol=1e-6)
