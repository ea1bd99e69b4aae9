"""PyTorch port vs the JAX package: the renderer and the real photo pool,
draw for draw.

The port cannot reproduce ``jax.random`` bits; its functions draw from a
sampler in the JAX functions' call order. Here the JAX function runs
eagerly with ``jax.random.{uniform,normal,bernoulli,randint}`` recorded
(``torch_draws.record_draws``) and the port replays the same values
(``ReplaySampler``), which also checks that both draw the same sites in the
same order with the same shapes.

Tolerances: rendered images within 1e-5 and landmarks within 1e-4 px
(float32 elementwise math in another library). The real pool's canvases
are bilinear samples of a photo at float32 positions that may differ in
the last bit (up to ~4e-5 px), which moves a value by the local gradient
times that distance; at the photo's edge (mask gradient 1 per px) that
reaches 3.8e-5, so they are held to 1e-4; its nearest patches and its
Z-frames to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_draws import (  # noqa: F401 (fair_torch_threads: autouse)
    ReplaySampler,
    StackedSampler,
    fair_torch_threads,
    real_sources,
    record_draws,
    write_photo_files,
)

from pyfaceanalysis_torch.training import synth as t_synth
from pyfaceanalysis_tpu.training import synth as j_synth

IMG_ATOL = 1e-5
LANDMARK_ATOL = 1e-4
PATCH_ATOL = 1e-5
REAL_ATOL = 1e-4



def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_patches(got, want, atol=PATCH_ATOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# --- renderer ----------------------------------------------------------------

RENDERS = [("v2", True, 3, (96, 112), 50.0, (50.0, 44.0), 12.0),
           ("v3", True, 4, (96, 112), 44.0, (60.0, 52.0), -8.0),
           ("v2", False, 5, (96, 112), 30.0, None, 0.0),
           ("v3", False, 6, (96, 112), 30.0, None, 0.0)]


@pytest.fixture(scope="module")
def jax_renders():
    out = []
    for cues, face, seed, hw, size, center, ang in RENDERS:
        with record_draws() as log:
            img, attrs = j_synth.render_face(
                jax.random.PRNGKey(seed), canvas_hw=hw, face_size=size,
                center=center, angle_deg=ang, with_face=face,
                attr_cues=cues)
        out.append((np.asarray(img), {k: np.asarray(v)
                                      for k, v in attrs.items()}, log))
    return out


@pytest.mark.parametrize("i", range(len(RENDERS)))
def test_render_face_replayed(jax_renders, i):
    cues, face, _, hw, size, center, ang = RENDERS[i]
    want, want_attrs, log = jax_renders[i]
    rs = ReplaySampler(log)
    img, attrs = t_synth.render_face(rs, hw, size, center, ang, face, cues)
    assert rs.done()
    assert img.shape == hw
    np.testing.assert_allclose(_np(img), want, rtol=0, atol=IMG_ATOL)
    for k, v in want_attrs.items():
        tol = LANDMARK_ATOL if k in ("eye_l", "eye_r", "mouth") else 1e-4
        np.testing.assert_allclose(_np(attrs[k]), v, rtol=1e-6, atol=tol)


def test_render_faces_batched_equals_single(jax_renders):
    """One batched render of the two v3-face / two v2 draws sets equals
    the single renders (per-face sizes, centres and angles as tensors)."""
    for pick in ((0,), (1,)):
        cues, face, _, hw, size, center, ang = RENDERS[pick[0]]
        logs = [jax_renders[pick[0]][2]] * 3
        sizes = torch.tensor([size, size * 1.1, size * 0.9])
        cx = torch.tensor([center[0], center[0] - 3.0, center[0] + 2.0])
        cy = torch.tensor([center[1], center[1] + 1.0, center[1] - 2.0])
        angs = torch.tensor([ang, -ang, 0.5 * ang])
        stacked = StackedSampler([ReplaySampler(lg) for lg in logs])
        imgs, attrs = t_synth.render_faces(stacked, 3, hw, sizes, (cx, cy),
                                           angs, face, cues)
        assert all(s.done() for s in stacked.samplers)
        for j in range(3):
            one, one_attrs = t_synth.render_face(
                ReplaySampler(logs[j]), hw, float(sizes[j]),
                (float(cx[j]), float(cy[j])), float(angs[j]), face, cues)
            np.testing.assert_allclose(_np(imgs[j]), _np(one), rtol=0,
                                       atol=1e-6)
            for k in attrs:
                np.testing.assert_allclose(_np(attrs[k][j]),
                                           _np(one_attrs[k]), rtol=1e-6,
                                           atol=1e-5)


def test_ou_walk_replayed():
    with record_draws() as log:
        want = np.asarray(j_synth.ou_walk(jax.random.PRNGKey(2), 50,
                                          -3.0, 5.0))
    rs = ReplaySampler(log)
    got = _np(t_synth.ou_walk(rs, 50, -3.0, 5.0))
    assert rs.done()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_value_noise_edges():
    """The bilinear upsampling of the lattices, edge rows and columns
    included, matches jax.image.resize(..., "linear")."""
    lat = np.random.RandomState(0).uniform(-1, 1, (2, 6, 6)).astype(
        np.float32)
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(a), (45, 70),
                                                 "linear")) for a in lat])

    class One:
        device = torch.device("cpu")

        def uniform(self, shape, lo, hi):
            return torch.as_tensor(lat)

    got = _np(t_synth._value_noise(One(), 2, (45, 70), grids=(6,),
                                   weights=(1.0,)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- the real-photo pool -----------------------------------------------------

@pytest.fixture(scope="module")
def photo_files(tmp_path_factory):
    return write_photo_files(str(tmp_path_factory.mktemp("real")))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return real_sources(str(tmp_path_factory.mktemp("pool")))


def test_real_source_load_and_mined(sources):
    js, ts = sources
    np.testing.assert_array_equal(ts._stack.numpy(), np.asarray(js._stack))
    np.testing.assert_array_equal(ts._valid.numpy(), np.asarray(js._valid))
    assert ts.num_faces == js.num_faces == 6
    assert ts.num_mined == js.num_mined == 2
    np.testing.assert_array_equal(ts._mined, js._mined)
    for a, b in zip(ts._faces, js._faces):
        assert a[0] == b[0]
        for p, q in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(p, q)
    _same_patches(ts.sample_mined_patches(3, 16, (64, 64)),
                  js.sample_mined_patches(3, 16, (64, 64)))


def test_real_source_samples(sources, photo_files):
    js, ts = sources
    with record_draws() as log:
        want, want_attrs = js.sample_faces(5, 6, (120, 120), (40.0, 80.0),
                                           15.0)
    rs = ReplaySampler(log)
    got, attrs = ts.sample_faces(5, 6, (120, 120), (40.0, 80.0), 15.0,
                                 sampler=rs)
    assert rs.done()
    _same_patches(got, want, atol=REAL_ATOL)
    for k, v in want_attrs.items():
        np.testing.assert_array_equal(attrs[k], v)
    _same_patches(ts.sample_backgrounds(4, 5, (90, 90)),
                  js.sample_backgrounds(4, 5, (90, 90)), atol=REAL_ATOL)
    _, _, attrs_file = photo_files
    want, want_lab = js.sample_age_zframes(8, 5, attrs_file=attrs_file)
    got, lab = ts.sample_age_zframes(8, 5, attrs_file=attrs_file)
    _same_patches(got, want)
    for k in ("age", "race", "gender"):
        np.testing.assert_array_equal(lab[k], want_lab[k])
