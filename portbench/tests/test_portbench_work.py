"""The yardstick's fixed functions against hand counts, and the scene
generator's repeatability, at tiny sizes on the CPU."""

import os

import numpy as np
import pytest
import torch

from portbench import core, work
from portbench.reference.detect import Grid, Settings
from portbench.reference.model import load_model

ROOT = os.path.dirname(core.BENCH)
SHIPPED = os.path.join(ROOT, "SavedNetworksTPU")
# (fields, expanded inputs, outputs) of each layer of the shipped 64x64
# networks (net_disc, net_pose*, net_eye, net_disc_final).
LAYERS_64 = [(256, 32, 14), (128, 64, 14), (64, 64, 14), (32, 64, 14),
             (16, 64, 14), (8, 64, 14), (4, 64, 14), (2, 64, 17),
             (1, 70, 20)]
LAYERS_AGE = [(256, 36, 13), (128, 26, 13), (64, 26, 13), (32, 26, 13),
              (16, 26, 13), (8, 26, 13), (4, 26, 13), (2, 26, 16),
              (1, 32, 20)]


@pytest.fixture(scope="module")
def model():
    return load_model(SHIPPED, "cpu")


def _gauss(c, d):
    return c * (2 * d * d + 3 * d)


def test_network_and_gaussian_flops_by_hand(model):
    by_hand = 2 * sum(f * k * o for f, k, o in LAYERS_64)
    assert by_hand == 688112
    for name in ("net_disc", "net_pose0", "net_pose1as", "net_disc_final"):
        assert work.network_flops(model.nets[name]) == by_hand
    assert work.network_flops(model.nets["net_age"]) == 2 * sum(
        f * k * o for f, k, o in LAYERS_AGE)
    assert model.clf("Disc1").flops_per_row() == _gauss(10, 9)
    assert model.clf("PosX0").flops_per_row() == _gauss(50, 10)


def test_flops_per_image_by_hand(model):
    s = Settings.resolve({}, model.calibration)
    g = Grid(200, 160, model.face, s)
    assert g.n_real == 260             # the grid scales with the image
    # 17 stages; stages 0-10 (7 with a network of their own) run the
    # grid's 260 rows, stages 11-16 (4 networks) the 256 that rung 2
    # keeps. Each row runs its stage's Gaussian form (C, D).
    stage_gauss = [(10, 9), (50, 10), (50, 20), (50, 20), (50, 20),
                   (10, 9), (50, 20), (50, 20), (50, 20), (50, 20),
                   (10, 9), (50, 20), (50, 20), (50, 20), (50, 20),
                   (10, 9), (10, 9)]
    grid = (260 * (7 * 688112 + sum(_gauss(c, d)
                                    for c, d in stage_gauss[:11]))
            + 256 * (4 * 688112 + sum(_gauss(c, d)
                                      for c, d in stage_gauss[11:])))
    eye = 688112 + _gauss(50, 12) + _gauss(50, 10)
    head = (2 * sum(f * k * o for f, k, o in LAYERS_AGE) + _gauss(39, 4)
            + 2 * _gauss(2, 5))
    assert work.flops_per_image(model, s, g, 0) == grid
    assert work.flops_per_image(model, s, g, 3) == (
        grid + 3 * (2 * eye + head))


def test_stage_rows_follow_the_rungs(model):
    s = Settings.resolve({}, model.calibration)
    rows = work.stage_rows(model, s, 1215, 16)
    assert rows[0] == (1215, 19440)
    assert rows[5] == (512, 16 * 512)         # after rung 1 (Disc1)
    assert rows[11] == (256, 16 * 256)        # after rung 2 (Disc5)
    rows = work.stage_rows(model, s, 260, 16)
    assert rows[0] == (260, 8192) and rows[5] == (260, 8192)
    assert rows[11] == (256, 4096)


def test_crop_bytes_by_hand(model):
    s = Settings.resolve({}, model.calibration)
    g = Grid(200, 160, model.face, s)
    texels = set()
    for lev, y, x in list(g.crops) + [(0, 0, 0)]:
        for i in range(64):
            for j in range(64):
                texels.add((lev, y + i, x + j))
    assert work.crop_texels(g, (64, 64)) == len(texels)
    # 260 windows in a 512 bucket; two images' 520 in 1,024.
    assert work.crop_bytes(g, s, 1, (64, 64)) == (
        len(texels) * 4 + 512 * 64 * 64 * 4 + 512 * 12)
    assert work.crop_bytes(g, s, 2, (64, 64)) == (
        2 * len(texels) * 4 + 1024 * 64 * 64 * 4 + 1024 * 12)


def test_gather_bytes_by_hand(model):
    s = Settings.resolve({}, model.calibration)
    g = Grid(200, 160, model.face, s)
    texels = [100, 200, 300, 400, 500, 600, 700]
    got = work.gather_bytes(model, g, s, 2, texels, (64, 64))
    # Refinement extractions at stages 3, 5, 8, 10 on the bucket of two
    # images' 520 rows, at 13 and 15 on rung 2's 256 per image, then the
    # eye pass: both eyes of 64 rows per image.
    rows = [1024] * 4 + [512] * 2 + [2 * 2 * 64]
    L = 2 * len(g.scales)
    assert got == [2 * t * 4 + r * 4096 * 4 + r * 24 + L * 4
                   for t, r in zip(texels, rows)]


def test_generator_repeats_and_keeps_heads_apart():
    gen = core.load_module("generators", "scenes_v1")
    mix = dict(width=240, height=160, faces=4, side=[30, 40],
               layout="cells", cells=[2, 2])
    a = gen.render(mix, 2 ** 31 + 5, 3, "cpu", chunk=2)
    b = gen.render(mix, 2 ** 31 + 5, 3, "cpu", chunk=2)
    c = gen.render(mix, 2 ** 31 + 6, 3, "cpu", chunk=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (160, 240) and a[0].dtype == np.float32
    assert 0.0 <= min(x.min() for x in a) and max(x.max() for x in a) <= 1.0
    with pytest.raises(ValueError):
        gen.render(dict(mix, side=[30, 90]), 1, 1, "cpu")


def test_round_operand_precisions():
    from portbench.reference.model import round_operand
    x = torch.tensor([[1.0 + 2 ** -12, 3.0, -7.5e-3, 1000.0]])
    assert torch.equal(round_operand(x, "f32"), x)
    assert round_operand(x, "bf16")[0, 0] == 1.0
    assert round_operand(x, "tf32")[0, 0] == 1.0
    assert round_operand(x, "fp8")[0, 3] == 1000.0       # the row's max
    r = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    err = {p: float((round_operand(r, p, per_row=True) - r).abs().max())
           for p in ("tf32", "bf16", "fp8")}
    assert 0 < err["tf32"] < err["bf16"] < err["fp8"]
