"""Device meshes and the sharded cascade, in one process.

Port of ``pyfaceanalysis_tpu.parallel.mesh``. PyTorch has no SPMD
partitioner, so the port runs ONE process that loops over the shards: a
"sharded" value is a list with one block per device of the mesh's axis (row
blocks of the leading axis, in device order) and a "replicated" value a
list with one copy per device. Kernel launches are asynchronous, so on
distinct cards the shards' work overlaps. A mesh may name one device more
than once (``make_mesh(n, device="cpu")`` gives n copies of the CPU, the
twin of the JAX tests' virtual CPU devices); blocks then stay where they
are and replicas are the same objects.

The JAX mesh partitions one global program, so the sharded cascade gives
the unsharded results. The port keeps that: every step that sees all rows
(the compaction rungs, the final ranking, the eye cap, a fused batch's
per-image top-k) runs on the mesh's first device over all rows
(``engine.cascade.run_cascade_shards``).
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from pyfaceanalysis_torch.engine import cascade as cascade_mod


class Mesh:
    """An array of devices with named axes, as ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        self.devices = np.frompyfunc(torch.device, 1, 1)(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def leader(self) -> torch.device:
        """The first device: where steps over all rows run."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at index 0."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` cards (default: all of them) or,
    with ``device="cpu"``, over ``n_devices`` copies of the CPU (default
    one). Raises when fewer cards exist than asked for: the JAX function
    would build a smaller mesh without a word."""
    kind = torch.device(device).type
    if kind == "cuda":
        count = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        n = n_devices or count
        if not 0 < n <= count:
            raise RuntimeError(
                f"make_mesh asked for {n} CUDA devices and found {count}"
                + ("" if count else " (CUDA is not available; pass "
                   "device='cpu' to run on the CPU)"))
        devices = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"no mesh for device type {kind!r}")
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} does not hold {len(devices)} "
                         "devices")
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axes)


def _tree_map(fn, tree):
    """``fn`` on every tensor, array and module of a tuple / NamedTuple /
    list / dict tree; None and other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray, nn.Module)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _module_device(module: nn.Module) -> Optional[torch.device]:
    for t in module.buffers():
        return t.device
    for t in module.parameters():
        return t.device
    return None


def shard_to(devices: Sequence[torch.device], tree) -> list:
    """One tree per device: every leaf split into contiguous row blocks
    along its leading axis (``torch.tensor_split``, so an uneven count
    still splits), block i on ``devices[i]``."""
    def block(i):
        def place(x):
            x = torch.as_tensor(x)
            return torch.tensor_split(x, len(devices))[i].to(devices[i])
        return place
    return [_tree_map(block(i), tree) for i in range(len(devices))]


def replicate_to(devices: Sequence[torch.device], tree) -> list:
    """One tree per device, every leaf on that device. A leaf already there
    is not copied; a module is deep-copied once per distinct device."""
    copies: dict = {}

    def place(d):
        def put(x):
            key = (id(x), str(d))
            if key not in copies:
                if isinstance(x, nn.Module):
                    copies[key] = (x if _module_device(x) == d
                                   else copy.deepcopy(x).to(d))
                else:
                    copies[key] = torch.as_tensor(x).to(d)
            return copies[key]
        return put
    return [_tree_map(place(d), tree) for d in devices]


def shard_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """Every leaf split along its leading (batch) axis over ``axis``: a list
    of trees, one per device along it, in device order."""
    return shard_to(mesh.axis_devices(axis), tree)


def replicate(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` per device of the mesh (flat order); no copy
    where the device already holds the leaf."""
    return replicate_to(list(mesh.devices.flat), tree)


def replicate_weights(mesh: Mesh, nets, clfs) -> list:
    """One (networks, classifiers) pair per device of the "data" axis: the
    same modules where they already are, one copy per other device."""
    return replicate_to(mesh.axis_devices("data"), (tuple(nets), tuple(clfs)))


def cascade_shards(mesh: Mesh, state: cascade_mod.CascadeState,
                   crops: Optional[torch.Tensor], weights: list,
                   image: torch.Tensor,
                   pyramid: Optional[torch.Tensor] = None,
                   pyr_scales: Optional[torch.Tensor] = None
                   ) -> List[cascade_mod.Shard]:
    """The window state and the crop table sharded over the "data" axis;
    the canvas, pyramid and scales replicated; ``weights`` from
    :func:`replicate_weights`."""
    devices = mesh.axis_devices("data")
    states = shard_to(devices, state)
    crop_blocks = (shard_to(devices, crops) if crops is not None
                   else [None] * len(devices))
    reps = replicate_to(devices, (image, pyramid, pyr_scales))
    return [cascade_mod.Shard(st, cr, w[0], w[1], *rep)
            for st, cr, w, rep in zip(states, crop_blocks, weights, reps)]


def sharded_cascade(mesh: Mesh, plan, nets, geom, cfg, patch_hw,
                    image: torch.Tensor, clfs,
                    state: cascade_mod.CascadeState,
                    pyramid: Optional[torch.Tensor] = None,
                    crops: Optional[torch.Tensor] = None,
                    pyr_scales: Optional[torch.Tensor] = None,
                    collect_trace: bool = False, n_images: int = 1,
                    n_per_image: int = 0):
    """``engine.cascade.run_cascade`` with the window batch sharded over
    ``mesh``'s "data" axis; weights, canvas and pyramid replicated. Each
    shard extracts, runs the networks and moves its own rows; the rungs
    rank all rows on the first device. Returns the final state gathered
    on that device (and the trace with ``collect_trace``)."""
    shards = cascade_shards(mesh, state, crops,
                            replicate_weights(mesh, nets, clfs), image,
                            pyramid, pyr_scales)
    return cascade_mod.run_cascade_shards(
        plan, geom, cfg, patch_hw, shards, collect_trace=collect_trace,
        n_images=n_images, n_per_image=n_per_image)
