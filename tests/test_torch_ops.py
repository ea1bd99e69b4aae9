"""PyTorch port vs the JAX package: image front end and the two kernels.

The JAX Pallas kernels run as the JAX suite runs them on the CPU
(``interpret=True``). Tolerances:

- the pyramid and the crops are copies: exact (atol 0);
- the rotated gather: the TPU kernel rounds texels to bf16 (an MXU rate
  trick), the port samples float32 texels, so they agree within the JAX
  suite's 6e-3 (tests/test_pallas.py); nearest samples within 1e-4 of a .5
  rounding tie may round either way and are excluded, as there;
- contrast ops: float32 reductions summed in another order, 1e-5.

The gather kernel computes its affine coefficients itself; a numpy float32
transcription of its arithmetic, operation by operation, must equal
``pyramid_affine`` bit for bit (no tolerance: one rounding per operation).

Tests marked ``cuda`` hold the CUDA kernels against their plain versions
on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.engine.eyes import _eye_levels as t_eye_levels
from pyfaceanalysis_torch.ops import contrast as t_contrast
from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather
from pyfaceanalysis_torch.ops.patches import (
    extract_patches_rotate as t_extract,
    level_coords,
    pyramid_affine,
    sample_patches_pyramid_ref,
)
from pyfaceanalysis_torch.ops.pyramid import build_pyramid as t_pyramid
from pyfaceanalysis_torch.ops.pyramid import crop_patches as t_crop
from pyfaceanalysis_tpu.engine.eyes import _eye_levels as j_eye_levels
from pyfaceanalysis_tpu.ops import contrast as j_contrast
from pyfaceanalysis_tpu.ops.pallas_crop import crop_patches_pallas
from pyfaceanalysis_tpu.ops.pallas_gather import sample_patches_pyramid
from pyfaceanalysis_tpu.ops.patches import extract_patches_rotate as j_extract
from pyfaceanalysis_tpu.ops.pyramid import build_pyramid as j_pyramid
from pyfaceanalysis_tpu.ops.pyramid import crop_patches as j_crop

GATHER_TOL = dict(rtol=0, atol=6e-3)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype or
                                                        torch.float32)


def _tie_mask(lx, ly):
    return ((np.abs(lx - np.floor(lx) - 0.5) < 1e-4)
            | (np.abs(ly - np.floor(ly) - 0.5) < 1e-4))


def _level_ties(scales, levels, boxes, angles, hw):
    coeffs = pyramid_affine(_t(scales), _t(levels, torch.int32), _t(boxes),
                            _t(angles), hw)
    lx, ly = level_coords(coeffs, hw)
    return _tie_mask(lx.numpy(), ly.numpy())


@pytest.fixture
def cuda_device():
    """The card, or a skip when there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("op", ["normalize", "enhance"])
def test_contrast_ops_match_jax(op):
    x = np.random.RandomState(0).rand(40, 64 * 64).astype(np.float32)
    x[3] = 0.5                                   # constant patch: eps path
    if op == "normalize":
        want = j_contrast.contrast_normalize_avg_std(jnp.asarray(x) * 255.0)
        got = t_contrast.contrast_normalize_avg_std(_t(x) * 255.0)
        tol = dict(rtol=1e-5, atol=1e-3)         # [0, 255] units
    else:
        want = j_contrast.contrast_enhance_patches(jnp.asarray(x), 0.11, 0.15)
        got = t_contrast.contrast_enhance_patches(_t(x), 0.11, 0.15)
        tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("hw,scales,level_hw", [
    ((200, 240), (1.3, 1.7, 2.21, 1.0), (208, 256)),
    ((97, 131), (0.8, 2.5, 7.3), (128, 256)),
    ((800, 1000), (2.9719020172910664, 6.3064512378236115,
                   13.382449011996409, 1.0), (808, 1024)),
])
def test_build_pyramid_exact(hw, scales, level_hw):
    img = np.random.RandomState(1).rand(*hw).astype(np.float32)
    want = np.asarray(j_pyramid(jnp.asarray(img), scales, level_hw))
    got = t_pyramid(_t(img), scales, level_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_crop_patches_matches_pallas_interpret():
    """The plain crop (the crop kernel's plain version) equals the JAX
    Pallas crop kernel exactly, at arbitrary residues against its (8, 128)
    snapping, and equals JAX's dynamic_slice crop when starts clamp."""
    img = np.random.RandomState(11).rand(256, 384).astype(np.float32)
    pyr = np.asarray(j_pyramid(jnp.asarray(img), (1.0, 2.0), (256, 384)))
    rng = np.random.RandomState(12)
    B = 32
    crops = np.stack([rng.randint(0, 2, B), rng.randint(0, 256 - 64, B),
                      rng.randint(0, 384 - 64, B)], 1).astype(np.int32)
    want = crop_patches_pallas(jnp.asarray(pyr), jnp.asarray(crops),
                               (64, 64), interpret=True)
    got = t_crop(_t(pyr), _t(crops, torch.int32), (64, 64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Starts past the level clamp as the Pallas kernel clips them (the grid
    # never produces them: make_grid_state falls back to the canvas).
    wild = np.array([[0, -5, 400], [1, 250, -3], [1, 300, 330]], np.int32)
    np.testing.assert_array_equal(
        t_crop(_t(pyr), _t(wild, torch.int32), (64, 64)).numpy(),
        np.asarray(crop_patches_pallas(jnp.asarray(pyr), jnp.asarray(wild),
                                       (64, 64), interpret=True)))
    # Non-negative starts past the end clamp like lax.dynamic_slice too.
    high = np.array([[0, 250, 400], [1, 193, 321]], np.int32)
    np.testing.assert_array_equal(
        t_crop(_t(pyr), _t(high, torch.int32), (64, 64)).numpy(),
        np.asarray(j_crop(jnp.asarray(pyr), jnp.asarray(high), (64, 64))))


def test_kernel_wrappers_use_plain_versions_on_cpu():
    """On CPU tensors the wrappers return the plain versions and launch
    nothing (the launch counts stay put)."""
    rng = np.random.RandomState(13)
    pyr = _t(rng.rand(2, 128, 256).astype(np.float32))
    crops = _t(np.array([[0, 3, 7], [1, 60, 190]], np.int32), torch.int32)
    n_crop, n_gather = cuda_crop.KERNEL.launches, cuda_gather.KERNEL.launches
    assert torch.equal(cuda_crop.crop_patches_kernel(pyr, crops, (64, 64)),
                       t_crop(pyr, crops, (64, 64)))
    scales = _t(np.array([1.0, 2.0], np.float32))
    levels = _t(np.array([0, 1], np.int32), torch.int32)
    boxes = _t(np.array([[10, 12, 80, 81], [40, 30, 150, 140]], np.float32))
    angles = _t(np.array([5.0, -12.0], np.float32))
    for method in ("nearest", "bilinear"):
        assert torch.equal(
            cuda_gather.sample_patches_pyramid(pyr, scales, levels, boxes,
                                               angles, (64, 64), method),
            sample_patches_pyramid_ref(pyr, scales, levels, boxes, angles,
                                       (64, 64), method))
    assert (cuda_crop.KERNEL.launches, cuda_gather.KERNEL.launches) == (
        n_crop, n_gather)


def _kernel_affine_numpy(scales, levels, boxes, angles, hw):
    """``csrc/gather.cu patch_level`` and ``patch_affine`` transcribed line
    by line: every operation on float32 values rounds once to float32.
    cos and sin are taken from torch (the kernel calls the functions that
    torch.cos and torch.sin call on the card)."""
    f = np.float32
    oh, ow = hw
    assert scales.dtype == boxes.dtype == angles.dtype == np.float32
    lev = np.minimum(np.maximum(levels.astype(np.int64), 0), len(scales) - 1)
    s_k = scales[lev]
    x0, y0, x1, y1 = (boxes[:, k] for k in range(4))
    bw = (x1 + f(1.0)) - x0
    bh = (y1 + f(1.0)) - y0
    cx = x0 + bw * f(0.5)
    cy = y0 + bh * f(0.5)
    rad = angles * f(0.017453292519943295)        # kDegToRad
    co = torch.cos(torch.from_numpy(rad)).numpy()
    si = torch.sin(torch.from_numpy(rad)).numpy()
    dx = x0 - cx
    dy = y0 - cy
    sw = f(ow) * s_k
    sh = f(oh) * s_k
    c = [(co * bw) / sw,
         (-si * bh) / sh,
         ((cx + co * dx) - si * dy) / s_k - f(0.5),
         (si * bw) / sw,
         (co * bh) / sh,
         ((cy + si * dx) + co * dy) / s_k - f(0.5)]
    assert all(v.dtype == np.float32 for v in c)
    return np.stack(c, axis=1)


def _affine_batch(seed, n_levels, B):
    """Levels beyond both clamps, negative, zero and +-45 degree angles,
    sub-pixel and large boxes, boxes off the canvas."""
    rng = np.random.RandomState(seed)
    scales = np.sort(rng.uniform(1.0, 14.0, n_levels)).astype(np.float32)
    scales[-1] = 1.0                                # native level last
    levels = rng.randint(-2, n_levels + 2, B)
    levels[:4] = (-5, 0, n_levels - 1, n_levels + 7)
    side = np.exp(rng.uniform(np.log(0.05), np.log(900.0), B))
    x0 = rng.uniform(-200, 1100, B)
    y0 = rng.uniform(-200, 900, B)
    boxes = np.stack([x0, y0, x0 + side - 1, y0 + side * 1.13 - 1],
                     1).astype(np.float32)
    angles = rng.uniform(-45, 45, B).astype(np.float32)
    angles[:6] = (0.0, -0.0, 45.0, -45.0, 1e-6, -22.5)
    return scales, levels, boxes, angles


@pytest.mark.parametrize("levels_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (40, 23)])
def test_kernel_affine_transcription_equals_pyramid_affine(hw, levels_dtype):
    """Pins the operation order the gather kernel follows: its arithmetic,
    transcribed in numpy float32, gives pyramid_affine's bits."""
    scales, levels, boxes, angles = _affine_batch(21, 8, 4000)
    levels = levels.astype(levels_dtype)
    want = pyramid_affine(_t(scales), torch.from_numpy(levels), _t(boxes),
                          _t(angles), hw).numpy()
    got = _kernel_affine_numpy(scales, levels, boxes, angles, hw)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_kernel_affine_transcription_is_order_sensitive():
    """The pin has teeth: regrouping one product (co * (bw / sw) for
    (co * bw) / sw) already changes bits on this batch."""
    scales, levels, boxes, angles = _affine_batch(21, 8, 4000)
    want = pyramid_affine(_t(scales), torch.from_numpy(levels), _t(boxes),
                          _t(angles), (96, 96)).numpy()
    lev = np.clip(levels, 0, len(scales) - 1)
    rad = torch.deg2rad(_t(angles))
    bw = (boxes[:, 2] + np.float32(1.0)) - boxes[:, 0]
    regrouped = torch.cos(rad).numpy() * (bw / (np.float32(96) * scales[lev]))
    assert (regrouped.view(np.uint32) != want[:, 0].view(np.uint32)).any()


def test_gather_wrapper_rejects_what_the_kernel_does_not_take():
    """The argument checks run before any launch, so a meta tensor (no
    card needed) reaches them."""
    pyr = torch.empty((2, 128, 256), device="meta")
    with pytest.raises(ValueError, match="no gather kernel"):
        cuda_gather.sample_patches_pyramid(
            pyr, torch.empty(2, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty((3, 4), device="meta"),
            torch.empty(3, device="meta"))
    scales = torch.ones(2)
    boxes, angles = torch.zeros((3, 4)), torch.zeros(3)
    levels = torch.zeros(3, dtype=torch.int32)
    ok = cuda_gather.patch_inputs(scales, levels, boxes, angles)
    assert ok[1] == (1, 1, 4, 1, 1) and ok[2] == 0
    view = torch.zeros((3, 3), dtype=torch.int64)[:, 0]
    assert cuda_gather.patch_inputs(scales, view, boxes, angles)[1:] == (
        (1, 3, 4, 1, 1), 1)
    for bad in ((scales, levels.float(), boxes, angles),
                (scales, levels, boxes.double(), angles),
                (scales, levels, boxes[:, :3], angles),
                (scales, levels[:2], boxes, angles),
                (scales[None], levels, boxes, angles)):
        with pytest.raises(ValueError):
            cuda_gather.patch_inputs(*bad)


def _canvas_ties(boxes, angles, hw):
    """Canvas-gather samples within 1e-4 px of a .5 rounding tie (float64
    evaluation of the same map)."""
    oh, ow = hw
    b = boxes.astype(np.float64)
    bw, bh = b[:, 2] + 1 - b[:, 0], b[:, 3] + 1 - b[:, 1]
    cx, cy = b[:, 0] + bw / 2, b[:, 1] + bh / 2
    u = b[:, 0, None, None] + ((np.arange(ow) + 0.5) / ow)[None, None] * \
        bw[:, None, None]
    v = b[:, 1, None, None] + ((np.arange(oh) + 0.5) / oh)[None, :, None] * \
        bh[:, None, None]
    rad = np.deg2rad(angles.astype(np.float64))[:, None, None]
    du, dv = u - cx[:, None, None], v - cy[:, None, None]
    px = cx[:, None, None] + np.cos(rad) * du - np.sin(rad) * dv - 0.5
    py = cy[:, None, None] + np.sin(rad) * du + np.cos(rad) * dv - 0.5
    return _tie_mask(px, py)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_extract_patches_rotate_matches_jax(method):
    """The canvas gather, including boxes hanging off the image. XLA's and
    torch's float32 cos/sin differ in the last bit for a few percent of
    angles, which moves sample positions by ~1e-5 px: nearest agrees
    exactly outside rounding ties, bilinear within 1e-4."""
    rng = np.random.RandomState(2)
    img = rng.rand(120, 150).astype(np.float32)
    B = 40
    side = rng.uniform(20, 90, B)
    x0 = rng.uniform(-30, 130, B)
    y0 = rng.uniform(-30, 100, B)
    boxes = np.stack([x0, y0, x0 + side - 1, y0 + side * 1.1 - 1],
                     1).astype(np.float32)
    angles = rng.uniform(-25, 25, B).astype(np.float32)
    for hw in ((64, 64), (32, 48)):
        want = np.asarray(j_extract(jnp.asarray(img), jnp.asarray(boxes),
                                    jnp.asarray(angles), hw, method=method))
        got = t_extract(_t(img), _t(boxes), _t(angles), hw,
                        method=method).numpy()
        if method == "nearest":
            got = np.where(_canvas_ties(boxes, angles, hw), want, got)
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _gather_case(seed, scales, level_hw, B, side_lo, side_hi, margin):
    rng = np.random.RandomState(seed)
    lh, lw = level_hw
    img = rng.rand(int(lh * min(scales)), int(lw * min(scales))
                   ).astype(np.float32)
    pyr = np.asarray(j_pyramid(jnp.asarray(img), scales, level_hw))
    side = rng.uniform(side_lo, side_hi, B)
    x0 = rng.uniform(-margin, img.shape[1] - side + margin)
    y0 = rng.uniform(-margin, img.shape[0] - side + margin)
    boxes = np.stack([x0, y0, x0 + side - 1, y0 + side - 1],
                     1).astype(np.float32)
    angles = rng.uniform(-22.5, 22.5, B).astype(np.float32)
    levels = rng.randint(0, len(scales), B).astype(np.int32)
    return pyr, np.asarray(scales, np.float32), levels, boxes, angles


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", ["unit", "multi_level", "out_of_level"])
def test_sample_patches_pyramid_ref_matches_pallas_interpret(case, method):
    """The plain level-space gather (the gather kernel's plain version) vs
    the JAX Pallas kernel in interpret mode: same level, same affine map,
    same zero fill outside the level."""
    if case == "unit":
        args = _gather_case(3, (1.0,), (128, 256), 12, 40, 64, 0)
    elif case == "multi_level":
        args = _gather_case(4, (1.0, 2.0), (256, 256), 12, 60, 110, 0)
    else:   # boxes hanging off the top-left and right of their levels
        args = _gather_case(5, (1.0, 1.5), (128, 256), 12, 50, 64, 30)
    pyr, scales, levels, boxes, angles = args
    hw = (64, 64)
    want = np.asarray(sample_patches_pyramid(
        jnp.asarray(pyr), jnp.asarray(scales), jnp.asarray(levels),
        jnp.asarray(boxes), jnp.asarray(angles), hw, method=method,
        interpret=True))
    got = sample_patches_pyramid_ref(_t(pyr), _t(scales),
                                     _t(levels, torch.int32), _t(boxes),
                                     _t(angles), hw, method=method).numpy()
    if method == "nearest":
        ties = _level_ties(scales, levels, boxes, angles, hw)
        got = np.where(ties, want, got)
    assert (got != 0).mean() > 0.5
    np.testing.assert_allclose(got, want, **GATHER_TOL)


@pytest.mark.parametrize("hw", [(96, 96), (64, 96), (40, 24)])
def test_sample_patches_pyramid_ref_other_sizes(hw):
    """Output sizes other than 64x64, bilinear (as tests/test_pallas.py)."""
    pyr, scales, levels, boxes, angles = _gather_case(
        6, (1.0, 1.7), (128, 256), 6, 40, 70, 0)
    want = np.asarray(sample_patches_pyramid(
        jnp.asarray(pyr), jnp.asarray(scales), jnp.asarray(levels),
        jnp.asarray(boxes), jnp.asarray(angles), hw, method="bilinear",
        interpret=True))
    got = sample_patches_pyramid_ref(_t(pyr), _t(scales),
                                     _t(levels, torch.int32), _t(boxes),
                                     _t(angles), hw, method="bilinear")
    np.testing.assert_allclose(got.numpy(), want, **GATHER_TOL)


def test_unit_level_gather_equals_canvas_gather():
    """At ladder scale 1.0 a level IS the canvas: the level-space nearest
    gather equals the canvas gather outside rounding ties."""
    rng = np.random.RandomState(7)
    img = rng.rand(128, 256).astype(np.float32)
    B = 16
    side = rng.uniform(40, 64, B)
    x0 = rng.uniform(0, 256 - side)
    y0 = rng.uniform(0, 128 - side)
    boxes = np.stack([x0, y0, x0 + side - 1, y0 + side - 1],
                     1).astype(np.float32)
    angles = rng.uniform(-20, 20, B).astype(np.float32)
    pyr = t_pyramid(_t(img), (1.0,), (128, 256))
    levels = np.zeros(B, np.int32)
    got = sample_patches_pyramid_ref(pyr, _t(np.ones(1, np.float32)),
                                     _t(levels, torch.int32), _t(boxes),
                                     _t(angles), (64, 64), "nearest")
    want = t_extract(_t(img), _t(boxes), _t(angles), (64, 64), "nearest")
    ties = _level_ties(np.ones(1, np.float32), levels, boxes, angles,
                       (64, 64))
    np.testing.assert_array_equal(np.where(ties, 0, got.numpy()),
                                  np.where(ties, 0, want.numpy()))


def test_eye_levels_match_jax():
    scales = np.asarray([1.35, 1.74, 2.23, 2.87, 1.0], np.float32)
    bw = np.asarray([40.0, 79.9, 80.0, 120.0, 200.0, 229.6, 1000.0],
                    np.float32)
    jl, jn = j_eye_levels(jnp.asarray(scales), jnp.asarray(bw))
    tl, tn = t_eye_levels(_t(scales), _t(bw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.int32


@pytest.mark.cuda
def test_crop_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.RandomState(8)
    pyr = _t(rng.rand(3, 808, 1024).astype(np.float32)).to(cuda_device)
    crops = np.stack([rng.randint(0, 3, 300), rng.randint(-5, 760, 300),
                      rng.randint(-5, 970, 300)], 1).astype(np.int32)
    crops = _t(crops, torch.int32).to(cuda_device)
    before = cuda_crop.KERNEL.launches
    got = cuda_crop.crop_patches_kernel(pyr, crops, (64, 64))
    torch.cuda.synchronize()
    assert cuda_crop.KERNEL.launches == before + 1
    assert torch.equal(got, t_crop(pyr, crops, (64, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("levels_as", ["int32", "int64", "int32_column"])
@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (40, 24), (17, 30),
                                (5, 7)])
def test_gather_kernel_matches_plain_on_card(cuda_device, method, hw,
                                             levels_as):
    """Widths that are and are not multiples of 4 (float4 and scalar
    stores), 32- and 64-bit levels, and levels as a strided column of a
    (B, 3) tensor, as the cascade passes them."""
    pyr, scales, levels, boxes, angles = _gather_case(
        9, (1.0, 1.5, 2.7), (256, 512), 64, 30, 200, 40)
    levels[:3] = (-1, 3, 7)                         # clamped by both versions
    dev = cuda_device
    if levels_as == "int32_column":
        t_levels = _t(np.stack([levels] * 3, 1), torch.int32).to(dev)[:, 0]
        assert not t_levels.is_contiguous()
    else:
        t_levels = _t(levels, getattr(torch, levels_as)).to(dev)
    args = (_t(pyr).to(dev), _t(scales).to(dev), t_levels,
            _t(boxes).to(dev), _t(angles).to(dev))
    before = cuda_gather.KERNEL.launches
    got = cuda_gather.sample_patches_pyramid(*args, hw, method)
    torch.cuda.synchronize()
    assert cuda_gather.KERNEL.launches == before + 1
    want = sample_patches_pyramid_ref(*args, hw, method)
    diff = (got - want).abs().cpu().numpy()
    if method == "nearest":
        diff = np.where(_level_ties(scales, levels, boxes, angles, hw), 0,
                        diff)
    assert diff.max() <= 1e-5


@pytest.mark.cuda
def test_gather_kernel_empty_batch_on_card(cuda_device):
    dev = cuda_device
    before = cuda_gather.KERNEL.launches
    got = cuda_gather.sample_patches_pyramid(
        torch.zeros((2, 128, 256), device=dev), torch.ones(2, device=dev),
        torch.zeros(0, dtype=torch.int64, device=dev),
        torch.zeros((0, 4), device=dev), torch.zeros(0, device=dev), (64, 64))
    assert got.shape == (0, 64, 64) and got.device.type == "cuda"
    assert cuda_gather.KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (40, 23)])
def test_gather_kernel_coefficients_equal_pyramid_affine_on_card(cuda_device,
                                                                 hw):
    """The coefficients the kernel computes on the card are pyramid_affine's
    bits on the card (same libdevice cosf/sinf, same operation order)."""
    scales, levels, boxes, angles = _affine_batch(22, 8, 200000)
    dev = cuda_device
    args = (_t(scales).to(dev), torch.from_numpy(levels).to(dev),
            _t(boxes).to(dev), _t(angles).to(dev))
    got = cuda_gather.kernel_affine(*args, hw)
    want = pyramid_affine(*args, hw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _fused_stack(dev, n_images=4, hw=(400, 500)):
    """A stacked pyramid with its folded grid, as detect_batch builds them:
    (pyramid (B*L, lh, lw), tiled scales (B*L,), folded crops, state, L)."""
    from pyfaceanalysis_torch.config import DetectorConfig, NetGeometry
    from pyfaceanalysis_torch.engine.cascade import make_batched_grid_state
    from pyfaceanalysis_torch.ops.pyramid import build_pyramid_batch
    rng = np.random.RandomState(31)
    stack = _t(rng.rand(n_images, *hw).astype(np.float32)).to(dev)
    state, n_real, pyr = make_batched_grid_state(
        hw[1], hw[0], NetGeometry(), DetectorConfig(), n_images, device=dev)
    pyramid = build_pyramid_batch(stack, pyr.scales, pyr.level_hw)
    scales = torch.tensor(pyr.scales * n_images, dtype=torch.float32,
                          device=dev)
    return pyramid, scales, pyr.crops, state, len(pyr.scales), n_real


@pytest.mark.cuda
def test_crop_kernel_fused_stack_on_card(cuda_device):
    """Folded crop levels over a stacked pyramid: exact, one launch, and
    every image's rows read that image's levels."""
    pyramid, _, crops, state, L, n_real = _fused_stack(cuda_device)
    before = cuda_crop.KERNEL.launches
    got = cuda_crop.crop_patches_kernel(pyramid, crops, (64, 64))
    torch.cuda.synchronize()
    assert cuda_crop.KERNEL.launches == before + 1
    assert torch.equal(got, t_crop(pyramid, crops, (64, 64)))
    img = (crops[: 4 * n_real, 0] // L).to(torch.int32)
    assert torch.equal(img, state.img_idx[: 4 * n_real])
    assert not torch.equal(got[:n_real], got[n_real: 2 * n_real])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_gather_kernel_fused_stack_on_card(cuda_device, method):
    """Folded levels (the strided int32 column of the crop table) and the
    tiled scales over a stacked pyramid: coefficients bit for bit, pixels
    equal outside rounding ties, one launch."""
    pyramid, scales, crops, state, L, n_real = _fused_stack(cuda_device)
    g = torch.Generator().manual_seed(5)
    n = crops.shape[0]
    boxes = state.boxes + (4.0 * torch.rand((n, 1), generator=g) - 2.0).to(
        cuda_device)
    angles = (48.0 * torch.rand(n, generator=g) - 24.0).to(cuda_device)
    levels = crops[:, 0]
    assert not levels.is_contiguous()
    want_c = pyramid_affine(scales, levels, boxes, angles, (64, 64))
    got_c = cuda_gather.kernel_affine(scales, levels, boxes, angles, (64, 64))
    assert torch.equal(got_c.view(torch.int32), want_c.view(torch.int32))
    before = cuda_gather.KERNEL.launches
    got = cuda_gather.sample_patches_pyramid(pyramid, scales, levels, boxes,
                                             angles, (64, 64), method)
    torch.cuda.synchronize()
    assert cuda_gather.KERNEL.launches == before + 1
    want = sample_patches_pyramid_ref(pyramid, scales, levels, boxes, angles,
                                      (64, 64), method)
    lx, ly = level_coords(want_c, (64, 64))
    ties = (((lx - torch.floor(lx) - 0.5).abs() < 1e-4)
            | ((ly - torch.floor(ly) - 0.5).abs() < 1e-4))
    assert int(((got != want) & ~ties).sum()) == 0
    assert float((got - want).abs().max()) <= (1.0 if method == "nearest"
                                               else 1e-5)
    # A wrong scale table (the ladder not tiled) is refused, not misread.
    with pytest.raises(ValueError, match="scales"):
        cuda_gather.sample_patches_pyramid(pyramid, scales[:L], levels, boxes,
                                           angles, (64, 64), method)
