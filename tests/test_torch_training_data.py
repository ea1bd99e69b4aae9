"""PyTorch port vs the JAX package: the training datasets, draw for draw.

The port cannot reproduce ``jax.random`` bits; its dataset builders draw
from a sampler in the JAX functions' call order. Here the JAX function runs
eagerly with ``jax.random.{uniform,normal,bernoulli,randint}`` recorded
(``torch_draws.record_draws``) and the port replays the same values
(``ReplaySampler``), which also checks that both draw the same sites in the
same order with the same shapes. The vmapped renders are replaced on both
sides by the same fixed canvases (``_render_batch``), or, for the age set,
by the same analytic ``render_face``.

Tolerances: labels exact; boxes within 1e-4 px; patches within 1e-5. The
port's float32 ``exp``/``cos`` may round a box coordinate or a sample
position to the neighbouring float32 of the JAX package's, and nearest
sampling then takes the neighbouring texel (the drift ROADMAP.md section 3
records for the cascade): a row whose extracted patch differs (in at most
1% of its pixels), at most 5% of the rows, is left out of the patch
comparison; every other row is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_draws import (  # noqa: F401 (fair_torch_threads: autouse)
    ReplaySampler,
    canvas_set,
    fair_torch_threads,
    real_sources,
    record_draws,
)

from pyfaceanalysis_torch.training import datasets as t_ds
from pyfaceanalysis_torch.training import synth as t_synth
from pyfaceanalysis_tpu.config import NetGeometry
from pyfaceanalysis_tpu.training import datasets as j_ds
from pyfaceanalysis_tpu.training import synth as j_synth

PATCH_ATOL = 1e-5
FLIP_ATOL = 1e-4
MAX_DRIFT_ROWS = 0.05



def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- datasets with fixed canvases --------------------------------------------

class BoxLog:
    """The (boxes, angles, nearest patches) of every ``_extract_batch``
    call of either package, flattened to rows in call order."""

    def __init__(self):
        self.jax, self.torch = [], []

    def exact_rows(self, n_rows):
        """Per output row: True where the port's extracted patch equals the
        JAX package's (rows past the recorded calls, e.g. mined patches,
        count as equal). Fails if a box differs by more than 1e-4 px or an
        angle by more than 1e-4 deg, or if a row that differs has more than
        1% of its pixels changed (a flip takes single texels)."""
        flags = []
        assert len(self.jax) == len(self.torch)
        for (jb, ja, jp), (tb, ta, tp) in zip(self.jax, self.torch):
            np.testing.assert_allclose(tb.reshape(-1, 4), jb.reshape(-1, 4),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(ta.reshape(-1), ja.reshape(-1),
                                       rtol=0, atol=1e-4)
            n = tp.shape[-1] * tp.shape[-2]
            moved = (np.abs(tp - jp) > FLIP_ATOL).reshape(-1, n).sum(axis=1)
            assert moved.max() <= 0.01 * n, moved.max()
            flags.append(moved == 0)
        flags = np.concatenate(flags) if flags else np.zeros(0, bool)
        return np.concatenate([flags, np.ones(n_rows - len(flags), bool)])


@pytest.fixture
def fixed_canvases(monkeypatch):
    """Both packages' _render_batch return the same canvases; every
    extraction's boxes are recorded (returns the BoxLog)."""
    def j_render(key, n, with_face=True, **kw):
        img, attrs = canvas_set(n, with_face, n + 100 * with_face)
        return jnp.asarray(img), {k: jnp.asarray(v) for k, v in attrs.items()}

    def t_render(sampler, n, with_face=True, **kw):
        img, attrs = canvas_set(n, with_face, n + 100 * with_face)
        return torch.as_tensor(img), {k: torch.as_tensor(v)
                                      for k, v in attrs.items()}
    log = BoxLog()
    j_extract, t_extract = j_ds._extract_batch, t_ds._extract_batch

    def j_rec(imgs, boxes, angles):
        out = j_extract(imgs, boxes, angles)
        log.jax.append((np.asarray(boxes), np.asarray(angles),
                        np.asarray(out)))
        return out

    def t_rec(imgs, boxes, angles):
        out = t_extract(imgs, boxes, angles)
        log.torch.append((_np(boxes), _np(angles), _np(out)))
        return out
    monkeypatch.setattr(j_ds, "_render_batch", j_render)
    monkeypatch.setattr(t_ds, "_render_batch", t_render)
    monkeypatch.setattr(j_ds, "_extract_batch", j_rec)
    monkeypatch.setattr(t_ds, "_extract_batch", t_rec)
    return log


def _replay(jax_fn, *args, **kw):
    with record_draws() as log:
        out = jax_fn(jax.random.PRNGKey(7), *args, **kw)
    return out, ReplaySampler(log)


def _same_patches(got, want, boxes=None, atol=PATCH_ATOL):
    """Patches within PATCH_ATOL; with a BoxLog, only the rows whose
    nearest extraction equals the JAX package's (at most MAX_DRIFT_ROWS of
    them may differ: see the module's text)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    rows = np.ones(len(got), bool)
    if boxes is not None:
        rows = boxes.exact_rows(len(got))
        assert (~rows).sum() <= MAX_DRIFT_ROWS * len(rows), (~rows).sum()
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=atol)


@pytest.mark.parametrize("cn,noise", [(True, 0.0), (False, 0.08)])
def test_pose_dataset_replayed(fixed_canvases, cn, noise):
    geom = NetGeometry()
    (want, want_lab), rs = _replay(
        j_ds.pose_dataset, 4, 6, geom, 40.0, 20.0, 22.5,
        contrast_normalize=cn, texture_noise=noise)
    got, lab = t_ds.pose_dataset(rs, 4, 6, geom, 40.0, 20.0, 22.5,
                                 contrast_normalize=cn, texture_noise=noise)
    assert rs.done()
    _same_patches(got, want, fixed_canvases)
    for k in ("dx", "dy", "ang", "scale"):
        np.testing.assert_array_equal(lab[k], want_lab[k])


def test_disc_dataset_replayed(fixed_canvases):
    geom = NetGeometry()
    (want, cls, avg, frac), rs = _replay(
        j_ds.disc_dataset, 4, 6, geom, contrast_normalize=True,
        texture_noise_bg=0.08, return_frac=True)
    got, tcls, tavg, tfrac = t_ds.disc_dataset(
        rs, 4, 6, geom, contrast_normalize=True, texture_noise_bg=0.08,
        return_frac=True)
    assert rs.done()
    _same_patches(got, want, fixed_canvases)
    np.testing.assert_array_equal(tcls, cls)
    np.testing.assert_array_equal(tavg, avg)
    np.testing.assert_array_equal(tfrac, np.asarray(frac, np.float64))


def test_residual_and_eye_datasets_replayed(fixed_canvases):
    geom = NetGeometry()
    want, rs = _replay(j_ds.residual_dataset, 4, 6, geom,
                       contrast_normalize=True)
    got = t_ds.residual_dataset(rs, 4, 6, geom, contrast_normalize=True)
    assert rs.done()
    _same_patches(got, want, fixed_canvases)
    fixed_canvases.jax.clear()
    fixed_canvases.torch.clear()
    eye_geom = NetGeometry(Dx=8, Dy=8, Dang=0, mins=0.675, maxs=0.975,
                           regression_width=64, regression_height=64)
    (want, want_lab), rs = _replay(j_ds.eye_dataset, 4, 6, eye_geom,
                                   texture_noise=0.05)
    got, lab = t_ds.eye_dataset(rs, 4, 6, eye_geom, texture_noise=0.05)
    assert rs.done()
    _same_patches(got, want, fixed_canvases)
    for k in ("x", "y"):
        np.testing.assert_array_equal(lab[k], want_lab[k])


def _zframe(hw, face_size, cx, cy, lib):
    """An analytic Z-frame 'face' for the age set: a smooth pattern of the
    canvas coordinates around the given centre, the same in jnp and torch;
    attrs are functions of the size."""
    H, W = hw
    yy = lib.arange(H, dtype=lib.float32)[:, None]
    xx = lib.arange(W, dtype=lib.float32)[None, :]
    u = (xx - cx) / face_size
    v = (yy - cy) / face_size
    img = 0.5 + 0.3 * lib.exp(-(u * u + v * v) * 4.0) + 0.05 * u * v
    return img, face_size * 0.5, face_size - 100.0, cx - cy


def test_age_dataset_replayed(monkeypatch):
    def j_render(key, canvas_hw, face_size, center, attr_cues="v3", **kw):
        img, a, r, g = _zframe(canvas_hw, face_size, center[0], center[1],
                               jnp)
        return img, {"age": a, "race": r, "gender": g}

    def t_render(sampler, n, canvas_hw, face_size, center, attr_cues="v3",
                 **kw):
        img, a, r, g = _zframe(canvas_hw, face_size[:, None, None],
                               center[0][:, None, None],
                               center[1][:, None, None], torch)
        return img, {"age": a[:, 0, 0], "race": r[:, 0, 0],
                     "gender": g[:, 0, 0]}
    monkeypatch.setattr(j_synth, "render_face", j_render)
    monkeypatch.setattr(t_synth, "render_faces", t_render)
    (want, want_lab), rs = _replay(j_ds.age_dataset, 10, chunk=4,
                                   jitter_px=4.0, jitter_scale=0.06,
                                   texture_noise=0.05)
    got, lab = t_ds.age_dataset(rs, 10, chunk=4, jitter_px=4.0,
                                jitter_scale=0.06, texture_noise=0.05)
    assert rs.done()
    _same_patches(got, want)
    for k in ("age", "race", "gender"):
        np.testing.assert_allclose(lab[k], want_lab[k], rtol=1e-6)


# --- mined patches ------------------------------------------

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return real_sources(str(tmp_path_factory.mktemp("pool")))


def test_disc_dataset_mined(fixed_canvases, sources, monkeypatch):
    """Mined false-positive patches join the disc background class, with
    background-only texture noise."""
    js, ts = sources
    geom = NetGeometry()
    kw = dict(num_classes=3, real_frac=0.0, real_bg_frac=0.0,
              mined_frac=0.5, texture_noise=0.03, texture_noise_bg=0.06)
    with record_draws() as log:
        want, cls, avg = j_ds.disc_dataset(jax.random.PRNGKey(9), 4, 6,
                                           geom, real_source=js, **kw)
    rs = ReplaySampler(log)
    got, tcls, _ = t_ds.disc_dataset(rs, 4, 6, geom, real_source=ts, **kw)
    assert rs.done()
    # background: 13 patches of one synthetic canvas and 6 mined patches.
    assert (cls == 2).sum() == 19
    _same_patches(got, want, fixed_canvases)
    np.testing.assert_array_equal(tcls, cls)
