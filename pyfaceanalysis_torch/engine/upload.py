"""The image upload: grayscale rows on the host -> the padded float32
canvas on the detector's device.

Port of the JAX package's ``_to_canvas`` / ``_pad_convert`` pair. The
canvas holds each image rounded as the reference rounds it: ``x * 255``
in the dtype numpy gives ``np.asarray(x) * 255.0``, clipped to [0, 255],
truncated to uint8, divided by 255 in float32, zeros outside the image.

On a card a float32 or float64 batch is uploaded as it is and rounded
there (:class:`Uploader`): the host copies the rows into a pinned staging
slot, a stream of the uploader's own copies the slot to the card without
blocking the host, and the conversion runs on the caller's stream behind
an event of that copy. Events also keep the host from overwriting a
pinned slot before its copy has completed, and the copy stream from
overwriting a device slot before the conversion that read it has run.
Other dtypes, and every dtype on the CPU, round on the host as numpy does
and convert with the same torch operations.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from pyfaceanalysis_torch.utils.profiling import annotate

# The dtypes whose rounding runs where the canvas is; numpy's product
# with 255.0 keeps each of them.
ROUNDED_ON_DEVICE = {np.dtype(np.float32): torch.float32,
                     np.dtype(np.float64): torch.float64}


def canvas_from_rows(rows: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, h, w) rows -> the (B, H, W) float32 canvas. Float rows are
    rounded here (``x * 255`` in their dtype, clipped, truncated to
    uint8); uint8 rows are rounded already."""
    B, h, w = rows.shape
    if rows.dtype != torch.uint8:
        rows = (rows * 255.0).clamp_(0, 255)
    canvas = torch.zeros((B, H, W), dtype=torch.uint8, device=rows.device)
    canvas[:, :h, :w] = rows
    return torch.div(canvas, 255.0)          # float32, as .to(float32) / 255


def host_rows(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """The rows as one (B, h, w) array ready for :func:`canvas_from_rows`:
    as they are when they share a dtype rounded on the device, else each
    rounded to uint8 on the host as numpy rounds it."""
    if arrays[0].dtype in ROUNDED_ON_DEVICE and all(
            a.dtype == arrays[0].dtype for a in arrays):
        return np.stack(arrays)
    return np.stack([np.clip(a * 255.0, 0, 255).astype(np.uint8)
                     for a in arrays])


class _Slot:
    """A pinned host buffer, its device twin, and the events after which
    each may be written again."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.dev: Optional[torch.Tensor] = None
        self.copied = torch.cuda.Event()    # the copy out of ``host``
        self.read = torch.cuda.Event()      # the conversion out of ``dev``


class Uploader:
    """A detector's upload to ``device``: :meth:`canvas` of a batch.

    On a card it owns ``slots`` staging slots, used in turn and each grown
    to the largest batch it has met, and a copy stream; both are made on
    the first upload. Callers on several threads take turns."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._n = max(1, int(slots))
        self._ring: List[_Slot] = []
        self._next = 0
        self._stream = None
        self._lock = threading.Lock()

    def canvas(self, images: Sequence[np.ndarray], H: int, W: int,
               request=None) -> torch.Tensor:
        """B same-sized (h, w) images -> their (B, H, W) float32 canvas on
        the device, in a ``pfa.upload`` span that counts the ``bytes`` the
        host sent to the card and whether they left from pinned memory
        (``pinned`` 1)."""
        with annotate("pfa.upload", request=request, bytes=0,
                      pinned=0) as span:
            arrays = [np.asarray(im) for im in images]
            dtype = arrays[0].dtype
            if (self.device.type != "cuda" or dtype not in ROUNDED_ON_DEVICE
                    or any(a.dtype != dtype for a in arrays)):
                rows = torch.from_numpy(host_rows(arrays))
                if self.device.type == "cuda":
                    span.update(bytes=rows.nbytes)
                    rows = rows.to(self.device)
                return canvas_from_rows(rows, H, W)
            with self._lock:
                slot, rows = self._staged(arrays, ROUNDED_ON_DEVICE[dtype])
                span.update(bytes=rows.nbytes, pinned=1)
                canvas = canvas_from_rows(rows, H, W)
                slot.read.record(torch.cuda.current_stream(self.device))
                return canvas

    def _staged(self, arrays: Sequence[np.ndarray], dtype: torch.dtype):
        """The next slot, and the rows in its device buffer, which the
        current stream reads behind the copy's event."""
        if not self._ring:
            self._ring = [_Slot() for _ in range(self._n)]
            self._stream = torch.cuda.Stream(device=self.device)
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self._n
        shape = (len(arrays),) + arrays[0].shape
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if slot.host is not None and not slot.copied.query():
            with annotate("pfa.upload.wait"):
                slot.copied.synchronize()
        if slot.host is None or slot.host.numel() < nbytes:
            slot.host = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        host = slot.host[:nbytes].view(dtype).view(shape)
        # One call for the batch: each call that releases the interpreter
        # lock waits to take it back from the stream's other threads.
        torch.stack([torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays], out=host)
        current = torch.cuda.current_stream(self.device)
        if slot.dev is None or slot.dev.numel() < nbytes:
            slot.dev = torch.empty(nbytes, dtype=torch.uint8,
                                   device=self.device)
            # A new block is ready in the current stream's order only.
            self._stream.wait_stream(current)
        dev = slot.dev[:nbytes].view(dtype).view(shape)
        with torch.cuda.stream(self._stream):
            if not slot.read.query():       # a wait is one hand-off more
                self._stream.wait_event(slot.read)
            dev.copy_(host, non_blocking=True)
            slot.copied.record(self._stream)
        current.wait_event(slot.copied)
        return slot, dev
