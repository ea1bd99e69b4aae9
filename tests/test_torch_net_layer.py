"""The HiGSFA layer kernel (``ops/cuda_net_layer.py``, ``csrc/net_layer.cu``).

On the CPU: ``Expansion.columns`` against the expansion's columns
(identity, spow, qt8, and a qtK with K above the field size), how the
wrapper reads a column table, what it refuses, the network's operand
being the plain version off the card (its operand, taken through the
product, is ``apply_layer``'s output, also when it reads the previous
layer's raw product with that layer's clip), the CPU networks launching
nothing, and the node's kept operands. On the card (marker
``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_net_layer.py`` on the card's machine, which has no JAX):
the kernel's operand, every layer's product and every network's output
bit-equal to the plain path on the card for each network of both artifact
directories, at 1, 512, 2,048 and 8,192 rows, bf16 and f32 operands; inputs
holding +-0, NaN, +-inf and values beyond the clip; the same inside a
captured and replayed CUDA graph, one launch per layer; column tables
that no expansion makes (copies and products mixed) and spow tables at
several exponents; and the kernel's spow of every float32 bit pattern at
the exponent 0.8, and of a sample at others, equal to the plain path's.
Imports no JAX.
"""

import glob
import os

import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.engine import graphs
from pyfaceanalysis_torch.io.artifacts import load_network
from pyfaceanalysis_torch.models import expansion as ex
from pyfaceanalysis_torch.models.expansion import Expansion
from pyfaceanalysis_torch.models.network import (
    LayerSpec,
    apply_layer,
    apply_network,
    layer_operand,
    layer_operand_ref,
    layer_product,
)
from pyfaceanalysis_torch.models.sfa import LinearNode
from pyfaceanalysis_torch.ops import cuda_net_layer as nl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETWORKS = sorted(glob.glob(os.path.join(ROOT, "SavedNetworksTPU*",
                                         "net_*.npz")))
DTYPES = {"bf16": torch.bfloat16, "f32": None}


def _from_table(table: np.ndarray, x: torch.Tensor,
                exponent: float = 0.8) -> torch.Tensor:
    """The columns the table names, each made by the plain path's op."""
    cols = []
    for op, a, b in table:
        v = x[..., a]
        if op == ex.SPOW:
            p = torch.abs(v).double() ** float(np.float32(exponent))
            v = torch.sign(v) * p.to(v.dtype)
        elif op == ex.MUL:
            v = v * x[..., b]
        cols.append(v)
    return torch.stack(cols, dim=-1)


@pytest.mark.parametrize("name,d", [("identity", 36), ("spow", 16),
                                    ("qt8", 28), ("qt8", 34), ("qt8", 5),
                                    ("qt12", 3)])
def test_the_column_table_is_the_expansion_order(name, d):
    table = Expansion(name).columns(d)
    assert table.shape == (Expansion(name).output_dim(d), 3)
    assert not table.flags.writeable
    x = torch.randn(7, 3, d, generator=torch.Generator().manual_seed(d))
    x[0, 0, 0] = -0.0
    assert torch.equal(_from_table(table, x), Expansion(name)(x))


def test_the_qt_table_is_triu_order():
    table = Expansion("qt8").columns(5)            # K > d: k = 5
    iu, ju = np.triu_indices(5)
    assert (table[:5] == [[ex.COPY, j, 0] for j in range(5)]).all()
    assert (table[5:, 0] == ex.MUL).all()
    assert (table[5:, 1] == iu).all() and (table[5:, 2] == ju).all()
    assert (nl.COPY, nl.SPOW, nl.MUL) == (ex.COPY, ex.SPOW, ex.MUL)
    with pytest.raises(ValueError):
        Expansion("cube").columns(4)


@pytest.mark.parametrize("name,k,pairs", [
    ("identity", 7, False), ("spow", 7, True), ("qt8", 28, False),
    ("qt3", 2, False)])
def test_the_wrapper_packs_an_expansion_table(name, k, pairs):
    table = Expansion(name).columns(k)
    cols, p = nl._columns_on(torch.device("cpu"), k, table.tobytes())
    assert p == pairs
    t = table.astype(np.int64)
    assert cols.dtype == torch.int32 and cols.tolist() == list(
        (t[:, 0] << 28) | (t[:, 1] << 14) | t[:, 2])


def test_other_tables_take_the_general_loop_and_spow_only_its_form():
    mixed = np.asarray([[ex.COPY, 3, 0], [ex.MUL, 0, 0], [ex.MUL, 1, 2],
                        [ex.COPY, 2, 0]], np.int32)
    _, pairs = nl._columns_on(torch.device("cpu"), 4, mixed.tobytes())
    assert not pairs
    spow = Expansion("spow").columns(4)
    mixed_spow = np.asarray([[ex.COPY, 3, 0], [ex.SPOW, 0, 0],
                             [ex.MUL, 1, 2]], np.int32)
    for table in (mixed_spow, spow[::-1].copy(), spow[:6].copy()):
        with pytest.raises(ValueError, match="spow columns only"):
            nl._columns_on(torch.device("cpu"), 4, table.tobytes())
    for bad in ([[3, 0, 0]], [[ex.COPY, 4, 0]], [[ex.MUL, 1, -1]]):
        with pytest.raises(ValueError, match="column table"):
            nl._columns_on(torch.device("cpu"), 4,
                           np.asarray(bad, np.int32).tobytes())


def _layer(seed=0, F=6, k=5, name="qt3", out=4, P=40, clip=4.0):
    rng = np.random.RandomState(seed)
    index = np.stack([rng.choice(P, k, replace=False) for _ in range(F)])
    spec = LayerSpec(tuple(map(tuple, index.tolist())), Expansion(name),
                     out, clip=clip)
    D = spec.expansion.output_dim(k)
    node = LinearNode(rng.randn(F, D).astype(np.float32),
                      np.asfortranarray(rng.randn(F, D, out)
                                        .astype(np.float32)))
    return spec, node, torch.as_tensor(index, dtype=torch.int64)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    spec, node, index = _layer()
    x = torch.rand(3, 40)
    cols = spec.expansion.columns(5)
    mean = node.mean_contiguous()
    bad = [
        ((x.double(), index, cols, mean), {}, "float32"),
        ((x[0], index, cols, mean), {}, "float32"),
        ((x.reshape(3, 1, 40, 1), index, cols, mean), {}, "float32"),
        ((x, index.int(), cols, mean), {}, "index"),
        ((x, index.t(), cols, mean), {}, "index"),
        ((x, index, cols, mean), {"compute_dtype": torch.float16},
         "compute_dtype"),
        ((x, index, cols[:-1], mean), {}, "mean"),
        ((x, index, cols[:, :2], mean), {}, "columns"),
        ((x, index, cols, mean.double()), {}, "mean"),
        ((x, index, cols, mean.t().contiguous().t()), {}, "mean"),
        ((x, index, cols, mean.to("meta")), {}, "device"),
        ((x, index, cols, mean), {}, "no layer kernel for device cpu"),
        ((x.to("meta"), index.to("meta"), cols, mean.to("meta")), {},
         "no layer kernel for device meta"),
    ]
    for args, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            nl.layer_operand(*args, 0.8, **kw)
    # Exponents at which torch's pow of a float64 tensor takes another
    # route than libdevice's pow (a spow table only).
    spow = Expansion("spow").columns(5)
    mean2 = torch.zeros(6, 10)
    for e in (0.0, 1.0, 2.0, 3.0, -2.0, 0.5, -0.5, -1.0):
        with pytest.raises(ValueError, match="exponent"):
            nl.layer_operand(x, index, spow, mean2, e)
    with pytest.raises(ValueError, match="device cpu"):
        nl.layer_operand(x, index, cols, mean, 2.0)     # no SPOW column
    wide = torch.zeros(1, 1 << 14, dtype=torch.int64)
    with pytest.raises(ValueError, match="too wide"):
        nl.layer_operand(torch.rand(2, 1 << 14), wide,
                         Expansion("identity").columns(1 << 14),
                         torch.zeros(1, 1 << 14), 0.8)
    assert nl.KERNEL.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["identity", "spow", "qt3", "qt9"])
def test_on_the_cpu_the_wrapper_is_the_plain_layer(name, dtype):
    cd = DTYPES[dtype]
    spec, node, index = _layer(name=name)
    x = torch.randn(9, 40, generator=torch.Generator().manual_seed(3)) * 3
    want = apply_layer(spec, node, index, x, compute_dtype=cd)
    xc = layer_operand(spec, node, index, x, compute_dtype=cd)
    assert torch.equal(xc, layer_operand_ref(spec, node, index, x,
                                             compute_dtype=cd))
    # The plain layer as it was: gather, expansion, the node's product.
    fields = spec.expansion(x[:, index])
    assert torch.equal(xc, node.centred(fields, cd))
    y = torch.einsum("bfd,fdo->bfo", xc, node.weights(cd))
    assert torch.equal(y, node(fields, compute_dtype=cd))
    assert torch.equal(y, layer_product(spec, node, index, x,
                                        compute_dtype=cd))
    got = torch.clamp(y, -spec.clip, spec.clip).reshape(9, -1)
    assert torch.equal(got, want)
    # The same layer reading a previous product as it is, with that
    # layer's clip applied on load: (9, 8, 5) laid out as an einsum leaves
    # it, beyond the clip in places.
    raw = (torch.randn(8, 9, 5, generator=torch.Generator().manual_seed(4))
           * 6).permute(1, 0, 2)
    assert not raw.is_contiguous()
    flat = torch.clamp(raw, -4.0, 4.0).reshape(9, 40)
    assert torch.equal(layer_operand(spec, node, index, raw, 4.0, cd),
                       layer_operand(spec, node, index, flat, None, cd))
    assert nl.KERNEL.launches == 0


@pytest.mark.parametrize("path", NETWORKS[:2], ids=os.path.basename)
def test_the_cpu_networks_take_the_plain_path(path):
    net = load_network(path)
    x = torch.rand(3, net.input_hw[0] * net.input_hw[1],
                   generator=torch.Generator().manual_seed(5))
    before = nl.KERNEL.launches
    for cd in DTYPES.values():
        y = x
        for spec, node, index in zip(net.specs, net.params, net.indices):
            y = apply_layer(spec, node, index, y, compute_dtype=cd)
        assert torch.equal(apply_network(net, x, compute_dtype=cd), y)
    assert nl.KERNEL.launches == before


def test_the_node_keeps_its_rounded_weights_and_row_major_mean():
    _, node, _ = _layer()
    W16 = node.weights(torch.bfloat16)
    assert node.weights(torch.bfloat16) is W16
    assert torch.equal(W16, node.W.to(torch.bfloat16).float())
    assert W16.stride() == node.W.stride()          # Fortran order kept
    assert node.weights(None) is node.W
    with torch.no_grad():
        node.W.mul_(2.0)                            # an in-place change
    W16b = node.weights(torch.bfloat16)
    assert W16b is not W16
    assert torch.equal(W16b, node.W.to(torch.bfloat16).float())
    fortran = LinearNode(np.asfortranarray(np.arange(12, dtype=np.float32)
                                           .reshape(3, 4)),
                         np.zeros((3, 4, 2), np.float32))
    assert not fortran.mean.is_contiguous()
    m = fortran.mean_contiguous()
    assert m.is_contiguous() and torch.equal(m, fortran.mean)
    assert fortran.mean_contiguous() is m


# -- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaNs included), with the same shape."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _plain_chain(net, x, cd):
    """The plain path on ``x``'s device: each layer's operand and product
    and the network's output."""
    operands, products, clip = [], [], None
    y = x
    for spec, node, index in zip(net.specs, net.params, net.indices):
        xc = layer_operand_ref(spec, node, index, y, clip, cd)
        y = torch.einsum("bfd,fdo->bfo", xc, node.W.to(cd).float()
                         if cd is not None else node.W)
        operands.append(xc)
        products.append(y)
        clip = spec.clip
    return operands, products, torch.clamp(y, -clip, clip).reshape(
        y.shape[0], -1)


def _kernel_chain(net, x, cd):
    operands, products, clip = [], [], None
    y = x
    for spec, node, index in zip(net.specs, net.params, net.indices):
        xc = layer_operand(spec, node, index, y, clip, cd)
        y = torch.einsum("bfd,fdo->bfo", xc, node.weights(cd))
        operands.append(xc)
        products.append(y)
        clip = spec.clip
    return operands, products


def _rows(n, P, seed, special=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, P, generator=g)
    if special:
        vals = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 7.5, -9.0, 1e-30, -1e-30, 1e30])
        pick = torch.randint(0, P, (n, 8), generator=g)
        x.scatter_(1, pick, vals[torch.randint(0, len(vals), (n, 8),
                                               generator=g)])
    return x


@pytest.fixture(scope="module")
def card_nets():
    dev = _card()
    return {p: load_network(p).to(dev) for p in NETWORKS}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 512, 2048, 8192])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_kernel_is_the_plain_path_on_every_network(card_nets, rows,
                                                       dtype):
    dev, cd = _card(), DTYPES[dtype]
    for i, (path, net) in enumerate(sorted(card_nets.items())):
        x = _rows(rows, net.input_hw[0] * net.input_hw[1], i).to(dev)
        want_ops, want_ys, want = _plain_chain(net, x, cd)
        before = nl.KERNEL.launches
        got_ops, got_ys = _kernel_chain(net, x, cd)
        got = apply_network(net, x, compute_dtype=cd)
        torch.cuda.synchronize()
        assert nl.KERNEL.launches - before == 2 * len(net.specs)
        for li, (a, b) in enumerate(zip(got_ops, want_ops)):
            assert a.is_contiguous() and a.stride() == b.stride()
            assert _bits_equal(a, b), f"{path} layer {li} operand"
        for li, (a, b) in enumerate(zip(got_ys, want_ys)):
            assert _bits_equal(a, b), f"{path} layer {li} product"
        assert _bits_equal(got, want), f"{path} output"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_special_values_and_the_clip_on_load(card_nets, dtype):
    dev, cd = _card(), DTYPES[dtype]
    for i, (path, net) in enumerate(sorted(card_nets.items())):
        x = _rows(512, net.input_hw[0] * net.input_hw[1], 100 + i,
                  special=True).to(dev)
        _, _, want = _plain_chain(net, x, cd)
        assert _bits_equal(apply_network(net, x, compute_dtype=cd), want)
        # Layer 1 on a raw product laid out as the einsum leaves it, with
        # special values and values beyond the clip.
        spec, node, index = net.specs[1], net.params[1], net.indices[1]
        G, O = net.specs[0].num_fields, net.specs[0].out_dim
        raw = (_rows(G * 512, O, 200 + i, special=True) * 12 - 6).reshape(
            G, 512, O).to(dev).permute(1, 0, 2)
        got = layer_operand(spec, node, index, raw, net.specs[0].clip, cd)
        want_op = layer_operand_ref(spec, node, index, raw,
                                    net.specs[0].clip, cd)
        assert _bits_equal(got, want_op), path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_replayed_graph_is_the_eager_kernel(card_nets, dtype):
    dev, cd = _card(), DTYPES[dtype]
    for i, (path, net) in enumerate(sorted(card_nets.items())):
        P = net.input_hw[0] * net.input_hw[1]
        x0, x1 = (_rows(512, P, 300 + i + j, special=j == 1).to(dev)
                  for j in (0, 1))
        eager = apply_network(net, x0, compute_dtype=cd)  # warms the tables
        g = graphs.capture(x0, lambda x: apply_network(net, x,
                                                       compute_dtype=cd))
        assert g.launches[graphs._COUNTED.index(nl.KERNEL)] == len(
            net.specs)
        before = nl.KERNEL.launches
        for x, want in ((x0, eager),
                        (x1, apply_network(net, x1, compute_dtype=cd))):
            got = g.replay(x)
            torch.cuda.synchronize()
            assert _bits_equal(got, want), path
        assert nl.KERNEL.launches - before == 3 * len(net.specs)


@pytest.mark.cuda
def test_spow_of_every_float32_is_the_plain_path():
    dev = _card()
    chunk = 1 << 27
    for lo in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32,
                         device=dev).view(torch.float32)
        want = torch.sign(x) * (torch.abs(x).double()
                                ** float(np.float32(0.8))).to(x.dtype)
        got = nl.spow_kernel(x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            f"bit patterns {lo} .. {lo + chunk}")


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [0.8, 0.65, 1.7, 3.3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_any_column_table_and_exponent(exponent, dtype):
    """A table no expansion makes (copies and products mixed) takes the
    kernel's general loop, spow's table at exponents other than 0.8
    libdevice's pow: each still the plain path."""
    dev, cd = _card(), DTYPES[dtype]
    rng = np.random.RandomState(7)
    F, k, P, B = 5, 6, 50, 777
    index = torch.as_tensor(np.stack([rng.choice(P, k, replace=False)
                                      for _ in range(F)]), device=dev)
    ops = rng.choice([ex.COPY, ex.MUL], 40)
    mixed = np.stack([ops, rng.randint(0, k, 40),
                      np.where(ops == ex.MUL, rng.randint(0, k, 40), 0)],
                     1).astype(np.int32)
    x = (_rows(B, P, 400, special=True) * 12 - 6).to(dev)
    for table in (mixed, Expansion("spow").columns(k)):
        mean = torch.as_tensor(rng.randn(F, len(table)).astype(np.float32),
                               device=dev)
        for clip in (None, 4.0):
            got = nl.layer_operand(x, index, table, mean, exponent, clip, cd)
            xx = x if clip is None else torch.clamp(x, -clip, clip)
            want = _from_table(table, xx[:, index], exponent) - mean[None]
            if cd is not None:
                want = want.to(cd).float()
            assert _bits_equal(got, want), (len(table), exponent, clip)


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [0.65, 1.5, 1.7, 3.3])
def test_spow_at_other_exponents_is_the_plain_path(exponent):
    dev = _card()
    g = torch.Generator().manual_seed(int(exponent * 10))
    x = torch.randint(-(1 << 31), 1 << 31, (1 << 24,), dtype=torch.int64,
                      generator=g).to(torch.int32).to(dev).view(torch.float32)
    x[:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                          -float("inf"), 1e-45, -1e-45, 3.4e38])
    want = torch.sign(x) * (torch.abs(x).double()
                            ** float(np.float32(exponent))).to(x.dtype)
    got = nl.spow_kernel(x, exponent)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
