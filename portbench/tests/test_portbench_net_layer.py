"""The reader of the layer kernel's device time (``metrics/
net_layer_ms_per_image.py``) on a hand-built trace: it gives its hand
count for both names, and nothing without ``net_layer_kernel`` records
(a program without the kernel) or without images."""

from types import SimpleNamespace

import pytest

from portbench import run as R
from portbench.trace import Trace

WINDOW = (1000, 11000)
KERNEL = ("void (anonymous namespace)::net_layer_kernel((anonymous "
          "namespace)::Args)")
DEVICE = [
    (KERNEL, 2000, 2300),                       # in the window
    ("_ZN12_GLOBAL__N_116net_layer_kernelENS_4ArgsE", 4000, 4500),
    (KERNEL, 10900, 11200),                     # starts inside
    (KERNEL, 500, 1500),                        # starts before
    (KERNEL, 11000, 11400),                     # starts at the end
    ("void (anonymous namespace)::gather_kernel<false>(float const*)",
     5000, 9000),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8", 6000, 7000),
]
# 300 + 500 + 300 ns over 4 images, in ms.
WANT = (300 + 500 + 300) / 1e6 / 4


def _ctx(device, images=4):
    return SimpleNamespace(trace=Trace(device, [], WINDOW, 1000, True),
                           images=images)


@pytest.mark.parametrize("name", ["net_layer_ms_per_image.stream",
                                  "net_layer_ms_per_image.single"])
def test_reader_gives_the_hand_count(name):
    assert R.metric_reader(name).read(_ctx(DEVICE)) == pytest.approx(WANT)


def test_nothing_without_the_kernel():
    other = [r for r in DEVICE if "net_layer" not in r[0]]
    reader = R.metric_reader("net_layer_ms_per_image.stream")
    assert reader.read(_ctx(other)) is None
    assert reader.read(_ctx(DEVICE[3:5])) is None   # none in the window


def test_nothing_without_images():
    reader = R.metric_reader("net_layer_ms_per_image.single")
    assert reader.read(_ctx(DEVICE, images=0)) is None
