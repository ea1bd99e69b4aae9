"""Draw-for-draw parity helpers for the training tests.

``record_draws`` wraps ``jax.random.{uniform,normal,bernoulli,randint}``
while a JAX function runs eagerly and keeps every value it drew, in call
order. ``ReplaySampler`` hands those values back to the port's functions,
which draw the same sites in the same order (a site drawn once per face
in JAX is drawn once per batch in the port, with the batch as the leading
axis: ``StackedSampler`` serves such a batch from per-face replays), and
the fixed canvases and photo files the dataset tests give both packages.
"""

import contextlib
import os

import jax
import numpy as np
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (fixture)

# The renderer's canonical layout (training.synth).
EYE_X, EYE_Y, MOUTH_Y = 0.1752, -0.1989, 0.1989

_KINDS = ("uniform", "normal", "bernoulli", "randint")


@contextlib.contextmanager
def record_draws():
    """Yields a list that fills with (kind, np.ndarray) per JAX draw."""
    log = []
    originals = {k: getattr(jax.random, k) for k in _KINDS}

    def wrap(kind):
        orig = originals[kind]

        def recorder(*args, **kwargs):
            out = orig(*args, **kwargs)
            log.append((kind, np.asarray(out)))
            return out
        return recorder

    try:
        for k in _KINDS:
            setattr(jax.random, k, wrap(k))
        yield log
    finally:
        for k, f in originals.items():
            setattr(jax.random, k, f)


class ReplaySampler:
    """A port sampler that returns recorded values in order; the kind and
    the element count of every request must match the recording."""

    def __init__(self, log, device="cpu"):
        self.log = list(log)
        self.pos = 0
        self.device = torch.device(device)

    def _next(self, kind, shape):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        assert self.pos < len(self.log), f"draw {self.pos} ({kind}) past " \
            f"the {len(self.log)} recorded"
        got_kind, value = self.log[self.pos]
        assert got_kind == kind, (self.pos, got_kind, kind)
        assert value.size == int(np.prod(shape)), (self.pos, kind,
                                                   value.shape, shape)
        self.pos += 1
        return np.array(value).reshape(shape)

    def done(self) -> bool:
        return self.pos == len(self.log)

    def uniform(self, shape=(), minval=0.0, maxval=1.0):
        return torch.as_tensor(self._next("uniform", shape), dtype=torch.float32,
                               device=self.device)

    def normal(self, shape=()):
        return torch.as_tensor(self._next("normal", shape), dtype=torch.float32,
                               device=self.device)

    def bernoulli(self, shape=(), p=0.5):
        return torch.as_tensor(self._next("bernoulli", shape), dtype=torch.bool,
                               device=self.device)

    def randint(self, shape, minval, maxval):
        return torch.as_tensor(self._next("randint", shape), dtype=torch.int64,
                               device=self.device)


class StackedSampler:
    """Serves a draw of shape (n, ...) from n per-item samplers, one draw
    of shape (...) each."""

    def __init__(self, samplers):
        self.samplers = list(samplers)
        self.device = self.samplers[0].device

    def _stack(self, kind, shape, *args):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        assert shape[0] == len(self.samplers), (shape, len(self.samplers))
        return torch.stack([getattr(s, kind)(shape[1:], *args)
                            for s in self.samplers])

    def uniform(self, shape=(), minval=0.0, maxval=1.0):
        return self._stack("uniform", shape, minval, maxval)

    def normal(self, shape=()):
        return self._stack("normal", shape)

    def bernoulli(self, shape=(), p=0.5):
        return self._stack("bernoulli", shape, p)

    def randint(self, shape, minval, maxval):
        return self._stack("randint", shape, minval, maxval)


def canvas_set(n, with_face, seed, hw=(240, 240)):
    """n smooth random canvases and annotation-convention attrs (faces of
    random size and angle near the canvas centre)."""
    rng = np.random.RandomState(seed)
    H, W = hw
    coarse = rng.rand(n, 14, 14)
    ys, xs = np.linspace(0, 12.999, H), np.linspace(0, 12.999, W)
    y0, x0 = ys.astype(int), xs.astype(int)
    ty, tx = (ys - y0)[:, None], (xs - x0)[None, :]
    c = coarse
    img = ((c[:, y0][:, :, x0] * (1 - tx) + c[:, y0][:, :, x0 + 1] * tx)
           * (1 - ty) + (c[:, y0 + 1][:, :, x0] * (1 - tx)
                         + c[:, y0 + 1][:, :, x0 + 1] * tx) * ty)
    img = (0.2 + 0.6 * img + 0.02 * rng.rand(n, H, W)).astype(np.float32)
    F = rng.uniform(40, 110, n)
    ang = rng.uniform(-20, 20, n) if with_face else np.zeros(n)
    ctr = np.stack([W / 2 + rng.uniform(-15, 15, n),
                    H / 2 + rng.uniform(-15, 15, n)], 1)
    rad = np.deg2rad(ang)
    R = np.stack([np.stack([np.cos(rad), -np.sin(rad)], -1),
                  np.stack([np.sin(rad), np.cos(rad)], -1)], -2)

    def place(u, v):
        return ctr + np.einsum("nij,nj->ni", R, np.stack([u * F, v * F], 1))

    attrs = {"eye_l": place(-EYE_X, EYE_Y),
             "eye_r": place(EYE_X, EYE_Y),
             "mouth": place(0.0, MOUTH_Y),
             "face_size": F, "angle": ang}
    if not with_face:
        attrs = {k: np.zeros_like(v) for k, v in attrs.items()}
    return img, {k: np.asarray(v, np.float32) for k, v in attrs.items()}


def write_photo_files(d):
    """A smooth written photo, its truth file, mined boxes and attribute
    file (as tests/test_mined_negatives.py writes them) in directory ``d``;
    returns (truth file, mined file, attribute file). Smooth, because
    bilinear resampling at float32 positions that differ in the last bit
    moves a value by the local gradient times that distance."""
    from PIL import Image
    arr = (canvas_set(1, False, 0, (200, 160))[0][0] * 255).astype(np.uint8)
    photo = os.path.join(d, "fake_photo.png")
    Image.fromarray(arr, mode="L").save(photo)
    gt = os.path.join(d, "gt.txt")
    with open(gt, "w") as f:
        f.write(photo + "\n")
        f.write("60.0 80.0 97.0 80.0 78.0 100.0 78.0 122.0\n")
    mined = os.path.join(d, "mined.txt")
    with open(mined, "w") as f:
        f.write("# mined hard negatives: filename x0 y0 x1 y1 angle\n")
        f.write(f"{photo} 10.0 130.0 70.0 190.0 5.0\n")
        f.write(f"{os.path.basename(photo)} 100.0 10.0 150.0 60.0 -12.0\n")
        f.write(os.path.join(d, "unknown.png") + " 0 0 10 10 0\n")
    attrs = os.path.join(d, "attrs.txt")
    with open(attrs, "w") as f:
        f.write("fake_photo.png 61 white female\n")
    return gt, mined, attrs


def real_sources(d):
    """The JAX package's and the port's (CPU) RealFaceSource on the files
    of :func:`write_photo_files`."""
    from pyfaceanalysis_torch.training.real import RealFaceSource as T
    from pyfaceanalysis_tpu.training.real import RealFaceSource as J
    gt, mined, _ = write_photo_files(d)
    return (J(gt, verbose=False, mined_file=mined),
            T(gt, verbose=False, mined_file=mined, device="cpu"))
