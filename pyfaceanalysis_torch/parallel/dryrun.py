"""Dry run of the sharded training and inference paths on an n-device mesh.

    python -m pyfaceanalysis_torch.parallel.dryrun [N] [--device cuda|cpu]

Port of the JAX package's ``__graft_entry__.dryrun_multichip``: the sharded
GSFA step on a data x model mesh, the production ``train_network`` on
serial and clustered graphs, the sharded cascade, a fused
``FaceDetector(data_mesh=N)`` batch and ``detect_stream`` under that mesh
against ``detect_batch``. The toy models are drawn from seeded
``torch.Generator``s (``models.init``), at the JAX toys' sizes: 16x16 and
32x32 patches, 96x96 and 96x112 images. On ``cuda`` (the default) the
mesh is the first n cards, and fewer cards raise; ``--device cpu`` runs it
on n copies of the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pyfaceanalysis_torch.config import DetectorConfig, NetGeometry


def _toy_model(patch_side: int = 16, top_dim: int = 8,
               device: str = "cuda"):
    """A tiny but structurally complete detection model (random weights):
    ``(geom, plan, nets, clfs)`` for ``engine.cascade.run_cascade``."""
    from pyfaceanalysis_torch.engine import cascade as cascade_mod
    from pyfaceanalysis_torch.io.pipeline import PipelineSpec, StageSpec
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.models.init import (
        random_classifier,
        random_network_params,
    )

    geom = NetGeometry(subimage_width=patch_side, subimage_height=patch_side)
    nets = tuple(random_network_params(
        builder.build_higsfa(patch_side, base_field=4, d=6, top_dim=top_dim),
        seed=s).to(device) for s in (0, 1))
    layout = [("Disc1", "net_disc", 0), ("PosX0", "net_pose", 1),
              ("PosY0", "None0", 2), ("PAng0", "None0", 3),
              ("Scale0", "None0", 4), ("Disc3", "net_disc", 5)]
    stages = tuple(StageSpec(t, n, f"clf{i}") for t, n, i in layout)
    # Padded with 5 head stages so detection_stages picks the 6 above.
    heads = tuple(StageSpec(t, "None0", "clfh")
                  for t in ("EyeLX", "EyeLY", "Age", "Race", "Gender"))
    spec = PipelineSpec(geom, geom, geom, stages + heads)
    ranges = {"Disc": (0.0, 1.0), "PosX": (-20, 20), "PosY": (-13, 13),
              "PAng": (-22, 22), "Scale": (0.7, 0.98)}
    clfs = tuple(random_classifier(top_dim, 8, *ranges[t[:-1]], seed=i)
                 .to(device) for t, _, i in layout)
    plan = cascade_mod.build_detection_plan(
        spec, {"net_disc": 0, "net_pose": 1}, [top_dim] * len(layout))
    return geom, plan, nets, clfs


def _toy_production_model(side: int = 32):
    """A randomly initialised, production-SHAPED ``DetectionModel`` (the
    trainer's 22-stage layout: 17 detection stages, eyes and the attribute
    heads), on the CPU."""
    from pyfaceanalysis_torch.engine.detector import DetectionModel
    from pyfaceanalysis_torch.io.pipeline import PipelineSpec, StageSpec
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.models.init import (
        random_classifier,
        random_network_params,
    )
    from pyfaceanalysis_torch.training.trainer import _STAGE_LAYOUT

    nets = {}
    for i, name in enumerate(["net_disc", "net_disc_final", "net_pose0",
                              "net_pose0as", "net_pose1", "net_pose1as",
                              "net_eye"]):
        nets[name] = random_network_params(
            builder.build_higsfa(side, d=6, top_dim=20), seed=i)
    nets["net_age"] = random_network_params(
        builder.build_pca_net(96, d=6, top_dim=20), seed=9)
    ranges = {"Disc": (0, 1), "PosX": (-5, 5), "PosY": (-5, 5),
              "PAng": (-10, 10), "Scale": (0.75, 0.9), "EyeLX": (-5, 5),
              "EyeLY": (-5, 5), "Age": (16, 58), "Race": (-2, 2),
              "Gender": (-1, 1)}
    classifiers = []
    for i, (t, _, _, dim) in enumerate(_STAGE_LAYOUT):
        lo, hi = ranges[t if t in ranges else t[:-1]]
        classifiers.append(random_classifier(dim, 4, lo, hi, seed=i))
    face_geom = NetGeometry(subimage_width=side, subimage_height=side)
    eye_geom = NetGeometry(Dx=8, Dy=8, Dang=0, mins=0.675, maxs=0.975,
                           subimage_width=side, subimage_height=side,
                           regression_width=64, regression_height=64)
    age_geom = NetGeometry(Dx=0, Dy=0, mins=1.14, maxs=1.14,
                           subimage_width=96, subimage_height=96,
                           regression_width=160, regression_height=160)
    stages = tuple(StageSpec(t, n, c) for t, n, c, _ in _STAGE_LAYOUT)
    return DetectionModel(PipelineSpec(face_geom, eye_geom, age_geom,
                                       stages), nets, classifiers)


def _toy_config(n_devices: int, bucket_lanes: int = 0,
                **kw) -> DetectorConfig:
    """The JAX toy detector's config: ``bucket_lanes`` (default the device
    count) multiplies the buckets, so a sharded and an unsharded detector
    can share bucket shapes."""
    lanes = bucket_lanes or max(1, n_devices)
    return DetectorConfig(
        smallest_face=0.4, data_mesh=n_devices,
        bucket_sizes=tuple(k * lanes for k in (32, 64, 128, 256)),
        cut_offs_face=(1.01,) * 10, **kw)


def _toy_detector(n_devices: int, bucket_lanes: int = 0,
                  device: str = "cuda", **kw):
    """FaceDetector over :func:`_toy_production_model` on ``device``,
    sharded over an ``n_devices`` data mesh (<= 1: unsharded)."""
    from pyfaceanalysis_torch.engine.detector import FaceDetector
    return FaceDetector(_toy_production_model(),
                        _toy_config(n_devices, bucket_lanes, **kw),
                        device=device)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Runs the sharded training and inference paths on an ``n_devices``
    mesh of ``device`` and checks what they return; raises on any
    failure, and when ``device`` has fewer than ``n_devices`` cards."""
    from pyfaceanalysis_torch.engine import cascade as cascade_mod
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.parallel.mesh import make_mesh, sharded_cascade
    from pyfaceanalysis_torch.parallel.train_step import (
        sharded_gsfa_step,
        sharded_train_network,
    )

    # -- sharded training step: data (samples) x model (fields) -------------
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_axis = n_devices // model_axis
    mesh2 = make_mesh(n_devices, ("data", "model"),
                      shape=(data_axis, model_axis), device=device)
    rng = np.random.RandomState(0)
    x = rng.randn(16 * data_axis, 4 * model_axis, 6).astype(np.float32)
    mean, W = sharded_gsfa_step(mesh2, x, out_dim=3)
    if not (torch.isfinite(mean).all() and torch.isfinite(W).all()):
        raise RuntimeError("[dryrun] the sharded GSFA step is not finite")
    print(f"[dryrun] sharded GSFA train step OK on mesh (data={data_axis}, "
          f"model={model_axis}); W {tuple(W.shape)}")

    # -- the production trainer under the data mesh ---------------------------
    mesh_d = make_mesh(n_devices, ("data",), device=device)
    tiny = builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
    xs = torch.from_numpy(rng.randn(24 * n_devices, 16 * 16)
                          .astype(np.float32)).to(mesh_d.leader)
    net_s = sharded_train_network(mesh_d, tiny, xs, graph="serial",
                                  labels=rng.rand(xs.shape[0]), num_groups=8)
    net_c = sharded_train_network(mesh_d, tiny, xs, graph="clustered",
                                  labels=rng.randint(0, 4, xs.shape[0]))
    for name, net in (("serial", net_s), ("clustered", net_c)):
        for p in net.params:
            if not torch.isfinite(p.W).all():
                raise RuntimeError(f"[dryrun] {name} weights not finite")
    print(f"[dryrun] production train_network OK on {n_devices}-device data "
          f"mesh (serial + clustered graphs, {len(net_s.params)} layers)")

    # -- sharded cascade: the window batch over the data axis -----------------
    geom, plan, nets, clfs = _toy_model(device=mesh_d.leader)
    cfg = DetectorConfig(
        bucket_sizes=tuple(k * n_devices for k in (8, 16, 32, 64, 128)))
    state, n_real, _ = cascade_mod.make_grid_state(96, 96, geom, cfg,
                                                   device=mesh_d.leader)
    image = torch.zeros((96, 96), dtype=torch.float32, device=mesh_d.leader)
    out = sharded_cascade(mesh_d, plan, nets, geom, cfg,
                          (geom.subimage_height, geom.subimage_width),
                          image, clfs, state)
    if not torch.isfinite(out.boxes).all():
        raise RuntimeError("[dryrun] sharded cascade boxes not finite")
    print(f"[dryrun] sharded cascade OK on {n_devices}-device data mesh; "
          f"batch {out.boxes.shape[0]} ({n_real} real windows)")

    # -- the user's path: FaceDetector(data_mesh=n), fused batch --------------
    det = _toy_detector(n_devices, device=device)
    rng2 = np.random.RandomState(1)
    imgs = [rng2.rand(96, 112).astype(np.float32) for _ in range(2)]
    dets = det.detect_batch(imgs, estimate_attributes=False)
    if len(dets) != 2 or not all(dets):
        raise RuntimeError(f"[dryrun] fused batch under the mesh found "
                           f"{[len(d) for d in dets]} detections")
    print(f"[dryrun] FaceDetector(data_mesh={n_devices}) fused detect_batch "
          f"OK: {[len(d) for d in dets]} detections")

    # -- the streamed path under the mesh, against detect_batch ---------------
    batches = [imgs, [rng2.rand(96, 112).astype(np.float32)
                      for _ in range(2)]]
    streamed = list(det.detect_stream(iter(batches),
                                      estimate_attributes=False))
    refs = [det.detect_batch(b, estimate_attributes=False) for b in batches]
    if len(streamed) != 2:
        raise RuntimeError(f"[dryrun] detect_stream yielded {len(streamed)} "
                           "batches")
    for got, ref in zip(streamed, refs):
        if [len(d) for d in got] != [len(d) for d in ref]:
            raise RuntimeError("[dryrun] detect_stream counts differ")
        for gi, ri in zip(got, ref):
            for g, r in zip(gi, ri):
                if not np.allclose(g.box, r.box, atol=1e-5):
                    raise RuntimeError("[dryrun] detect_stream boxes differ")
    print(f"[dryrun] detect_stream under data_mesh={n_devices} OK: "
          f"{[[len(d) for d in b] for b in streamed]} detections, equal to "
          "detect_batch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
