"""HiGSFA layer kernel: one layer's product operand in one launch.

Writes the (B, F, D) float32 left operand of a layer's product
``bfd,fdo->bfo`` with the hand-written CUDA kernel ``csrc/net_layer.cu``:
the previous layer's clip applied on load to its raw product output, the
switchboard gather, the expansion's columns as a column table gives them,
the centring by the node's mean and, with ``compute_dtype`` bfloat16, the
operand rounding. It replaces no TPU kernel (the JAX package leaves these
steps to XLA): in plain PyTorch they are about 13 element-wise kernels a
layer. Its plain version is ``models/network.py layer_operand_ref``; the
kernel performs the same IEEE operations and its operand is bit-equal
(see the note in the source). Bound by bytes: a row's inputs read once,
its operand written once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pyfaceanalysis_torch.ops.cuda_build import CudaLibrary, check_launch

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double
KERNEL = CudaLibrary("net_layer.cu", {
    # x, three element strides, G, O; clip, lo, hi; index, F, k;
    # cols, D, pairs; mean, expo, bf16; out, B; stream
    "pfa_net_layer_launch": [_P, _S, _S, _S, _I, _I, _I, _F, _F, _P, _I, _I,
                             _P, _I, _I, _P, _D, _I, _P, _I, _P],
    # x, out, n, expo; stream
    "pfa_net_layer_spow_launch": [_P, _P, _S, _D, _P]})

# A column table row's op, as the kernel reads it (the format of
# models/expansion.py Expansion.columns).
COPY, SPOW, MUL = 0, 1, 2
# Exponents at which torch's pow of a float64 tensor by a scalar does not
# call pow (a fill, a copy, x * x, x * x * x, 1 / (x * x), sqrt, rsqrt,
# reciprocal): the kernel's SPOW takes pow, so it refuses them.
TORCH_POW_SPECIALS = (0.0, 1.0, 2.0, 3.0, -2.0, 0.5, -0.5, -1.0)


@functools.lru_cache(maxsize=None)
def _columns_on(device: torch.device, k: int, rows: bytes
                ) -> Tuple[torch.Tensor, bool]:
    """A column table (its int32 bytes) checked and packed as the kernel
    reads it (op << 28 | a << 14 | b), copied to ``device`` once (by a
    layer's first, eager call: a graph's capture may make no host-to-device
    copy); with whether it is spow's form, the k inputs then their k spows,
    which the kernel makes a pair of columns at a time. SPOW columns come
    in no other form: the kernel's general loop makes copies and
    products only."""
    t = np.frombuffer(rows, np.int32).reshape(-1, 3).astype(np.int64)
    if (not np.isin(t[:, 0], (COPY, SPOW, MUL)).all()
            or not ((0 <= t[:, 1:]) & (t[:, 1:] < k)).all()):
        raise ValueError(f"not a column table over {k} inputs")
    j = np.arange(k)
    pairs = len(t) == 2 * k and bool(
        (t[:, 0] == np.repeat([COPY, SPOW], k)).all()
        and (t[:, 1] == np.tile(j, 2)).all())
    if not pairs and (t[:, 0] == SPOW).any():
        raise ValueError("the layer kernel takes spow columns only as "
                         "spow's expansion makes them")
    packed = (t[:, 0] << 28) | (t[:, 1] << 14) | t[:, 2]
    return torch.as_tensor(packed.astype(np.int32), device=device), pairs


def layer_operand(x: torch.Tensor, index: torch.Tensor, columns: np.ndarray,
                  mean: torch.Tensor, exponent: float,
                  clip: Optional[float] = None,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """The (B, F, D) float32 left operand of one layer's product, on a card.

    ``x``: the layer's (B, P) input rows, or the previous layer's (B, G, O)
    product output as the product left it (any strides) with that layer's
    ``clip`` (None: no clip), which applies on load. ``index``: the (F, k)
    int64 switchboard over a row's P = G * O inputs (flat, field-major).
    ``columns``: the (D, 3) column table of the expansion on k inputs
    (``Expansion.columns``), whose SPOW columns take ``exponent``,
    rounded to float32 (not one of ``TORCH_POW_SPECIALS``). ``mean``: the node's (F, D) float32 mean,
    contiguous, which centres the expanded fields. ``compute_dtype``
    bfloat16 rounds the operand to bf16 and back.

    Raises on what the kernel does not take, a tensor off the card
    included."""
    if x.dtype != torch.float32 or x.dim() not in (2, 3):
        raise ValueError("x must be (B, P) or (B, G, O) float32")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"no layer kernel for compute_dtype {compute_dtype}")
    if (index.dtype != torch.int64 or index.dim() != 2
            or not index.is_contiguous()):
        raise ValueError("index must be a contiguous (F, k) int64 tensor")
    F, k = index.shape
    if k >= 1 << 14:
        raise ValueError(f"fields of {k} inputs are too wide for the layer "
                         "kernel")
    columns = np.ascontiguousarray(columns, np.int32)
    if columns.ndim != 2 or columns.shape[1] != 3:
        raise ValueError("columns must be a (D, 3) table")
    D = len(columns)
    if (mean.dtype != torch.float32 or tuple(mean.shape) != (F, D)
            or not mean.is_contiguous()):
        raise ValueError(f"mean must be a contiguous ({F}, {D}) float32 "
                         "tensor")
    for t in (index, mean):
        if t.device != x.device:
            raise ValueError("index and mean must be on x's device")
    cols, pairs = _columns_on(x.device, k, columns.tobytes())
    if pairs and float(np.float32(exponent)) in TORCH_POW_SPECIALS:
        raise ValueError(f"no layer kernel for the spow exponent {exponent}")
    if x.device.type != "cuda":
        raise ValueError(f"no layer kernel for device {x.device}")
    B = x.shape[0]
    G, O = (1, x.shape[1]) if x.dim() == 2 else x.shape[1:]
    sb, sg, so = ((x.stride(0), 0, x.stride(1)) if x.dim() == 2
                  else x.stride())
    out = torch.empty((B, F, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    clip_on = clip is not None
    lib = KERNEL.lib()
    # The launch reads the current device's SM count.
    with torch.cuda.device(x.device):
        rc = lib.pfa_net_layer_launch(
            x.data_ptr(), sb, sg, so, G, O, int(clip_on),
            -clip if clip_on else 0.0, clip if clip_on else 0.0,
            index.data_ptr(), F, k, cols.data_ptr(), D, int(pairs),
            mean.data_ptr(), float(np.float32(exponent)),
            int(compute_dtype is not None), out.data_ptr(), B,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "layer kernel")
    KERNEL.launches += 1
    return out


def spow_kernel(x: torch.Tensor, exponent: float = 0.8) -> torch.Tensor:
    """The kernel's spow column, ``sign(x) * float(pow(double |x|, e))``
    with e = float32(exponent), elementwise on a contiguous CUDA float32
    tensor: for checks that hold it against the plain path (not on any
    path of the port, not counted as a launch)."""
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("spow_kernel takes a contiguous CUDA float32 tensor")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = KERNEL.lib().pfa_net_layer_spow_launch(
            x.data_ptr(), out.data_ptr(), x.numel(),
            float(np.float32(exponent)),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(rc, "spow kernel")
    return out
