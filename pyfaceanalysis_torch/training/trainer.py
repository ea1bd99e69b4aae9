"""Layer-wise HiGSFA training and full-pipeline artifact production.

Port of ``pyfaceanalysis_tpu.training.trainer``. Training a hierarchical
SFA network is layer-local: each layer is fit on the previous layer's
outputs, with the training graph shared by all receptive fields. Per layer,
on the trainer's device:

1. gather + expand the layer inputs,
2. accumulate graph moments (batched products, ``models.moments``),
3. solve the (F, D, D) generalized eigenproblems (batched ``eigh``),
4. propagate outputs to train the next layer.

``train_pipeline`` produces every artifact of the 22-stage pipeline: six
networks (two FaceCentering discriminators, the pose-refinement nets, one
eye net, one linear age net) and 22 Gaussian classifiers, with the
reference's feature-sharing layout (``None0`` stages reuse the previous
stage's features). Datasets stay on the device between rendering, fitting
and feature extraction; only (N, <=20) features and the layer weights come
to the host, where the Gaussian fits run in float64 numpy.

Random draws: the JAX package splits one ``PRNGKey(seed)`` into 12
dataset keys; here dataset k draws from ``Sampler((seed, k))`` (and disc
candidate s from ``Sampler((seed, k, s))``), a seeded CPU generator whose
values move to the device, so one seed gives the same datasets on the CPU
and on the card (not the JAX package's bits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from pyfaceanalysis_torch.config import NetGeometry, resolve_device
from pyfaceanalysis_torch.io import artifacts
from pyfaceanalysis_torch.io.pipeline import (
    PipelineSpec,
    StageSpec,
    write_pipeline,
)
from pyfaceanalysis_torch.models import builder, moments
from pyfaceanalysis_torch.models.network import HierarchicalNetwork, apply_layer
from pyfaceanalysis_torch.models.sfa import LinearNode
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor
from pyfaceanalysis_torch.parallel import mesh as mesh_mod
from pyfaceanalysis_torch.training import datasets
from pyfaceanalysis_torch.training.sampler import Sampler

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _timed(times: Dict[str, float], phase: str, device: torch.device):
    """Adds the host-clock seconds of the block, the device's work
    included, to ``times[phase]``."""
    t0 = time.perf_counter()
    yield
    _sync(device)
    times[phase] = times.get(phase, 0.0) + time.perf_counter() - t0


def train_network(net: HierarchicalNetwork, x: torch.Tensor,
                  graph: str = "temporal",
                  labels: Optional[np.ndarray] = None,
                  num_groups: int = 50, verbose: bool = True,
                  label_weights=None, mesh=None) -> HierarchicalNetwork:
    """Trains all layers of ``net`` on an (N, D_in) tensor with one shared
    graph, on the tensor's device.

    Each layer costs one gather + expansion and one (F, D, D) moment
    accumulation + batched eigensolve, all on that device; host labels only
    order the graph. Returns a new network on that device.

    With ``mesh`` (``parallel.mesh.make_mesh``) the samples and their
    labels are cut to a count that the mesh's "data" axis divides, and the
    samples are sharded over it: each device gathers, expands and
    propagates its own rows, the moments are sums of per-device partials
    on the first device (``models.moments``), the solve runs there and the
    weights go to every device. The network comes back on the first
    device.

    The layer inputs are expanded in float32, as the network runs them,
    and their moments accumulated in float64 (the JAX trainer accumulates
    float32). The serial scatter is a difference of large sums; with
    float32 sums its trailing slow directions follow the summation order:
    on tests/test_torch_parallel.py's serial set the JAX trainer, sharded
    or not, and a float32 port reproduced the 4th and 5th features of a
    float64 reference to canonical correlations of 0.69 and 0.05 to 0.61
    and 0.28, and an 8-way sharded float32 port to 0.9999, so unsharded
    and sharded runs parted. In float64 they agree.
    """
    if not isinstance(x, torch.Tensor):
        raise TypeError("train_network trains on a tensor, on its device")
    cur = x.to(torch.float32)
    if mesh is None:
        devices = [x.device]
        blocks = [cur]
    else:
        # A device-divisible sample count, as the JAX trainer cuts it.
        devices = mesh.axis_devices("data")
        n_keep = (cur.shape[0] // len(devices)) * len(devices)
        cur = cur[:n_keep]
        if labels is not None:
            labels = np.asarray(labels)[:n_keep]
        blocks = mesh_mod.shard_to(devices, cur)
    dev = devices[0]
    params = []
    for li, spec in enumerate(net.specs):
        t0 = time.perf_counter()
        indices = mesh_mod.replicate_to(devices, torch.as_tensor(
            spec.indices_array(), dtype=torch.int64))
        # The moments accumulate in float64 (see the docstring).
        inp = [spec.expansion(b[:, i]).double()
               for b, i in zip(blocks, indices)]
        de = inp[0].shape[-1]                            # (n, F, De) each
        if spec.node == "pca":
            mean, B = moments.mean_cov(inp)
            W = moments.solve_pca_device(B, spec.out_dim)
        else:
            mean, B, A = moments.gsfa_moments(inp, graph, labels=labels,
                                              num_groups=num_groups,
                                              label_weights=label_weights)
            if spec.node == "igsfa":
                slow = spec.slow_dim or max(spec.out_dim // 2, 1)
                W = moments.solve_igsfa_device(A, B, slow, spec.out_dim)
            else:
                W = moments.solve_gsfa_device(A, B, spec.out_dim)
        del inp
        node = LinearNode(mean, W)
        params.append(node)
        blocks = [apply_layer(spec, n, i, b) for b, n, i in zip(
            blocks, mesh_mod.replicate_to(devices, node), indices)]
        if verbose:
            _sync(dev)
            print(f"  layer {li}: fields={spec.num_fields} in={de} "
                  f"out={spec.out_dim} [{time.perf_counter() - t0:.1f}s]",
                  flush=True)
    return HierarchicalNetwork(net.specs, params, net.input_hw).to(dev)


def fit_regressor_bins(features: np.ndarray, values: np.ndarray,
                       input_dim: int, num_classes: int = 50,
                       reg: float = 1e-6) -> GaussianRegressor:
    """Discretizes a continuous label into quantile bins and fits per-class
    Gaussians on the host; avg_labels = per-class mean of the raw values
    (the reference classifiers' avg_labels are such class means)."""
    x = np.asarray(features)[:, :input_dim]
    v = np.asarray(values, np.float64)
    # Keep enough samples per class for a stable covariance.
    num_classes = max(2, min(num_classes, len(v) // (3 * input_dim + 10)))
    edges = np.quantile(v, np.linspace(0, 1, num_classes + 1)[1:-1])
    cls = np.searchsorted(edges, v)
    keep_classes, counts = np.unique(cls, return_counts=True)
    # Remap to dense ids, dropping classes too small for a covariance.
    valid = keep_classes[counts > input_dim + 2]
    remap = {c: i for i, c in enumerate(valid)}
    sel = np.isin(cls, valid)
    dense = np.array([remap[c] for c in cls[sel]])
    avg = np.array([v[sel][dense == i].mean() for i in range(len(valid))])
    return GaussianRegressor.fit(x[sel], dense, avg_labels=avg, reg=reg)


def fit_regressor_classes(features: np.ndarray, cls: np.ndarray,
                          avg_labels: np.ndarray, input_dim: int,
                          reg: float = 1e-6) -> GaussianRegressor:
    """Fits per-class Gaussians on pre-defined integer classes."""
    x = np.asarray(features)[:, :input_dim]
    cls = np.asarray(cls)
    present = np.unique(cls)
    remap = {c: i for i, c in enumerate(present)}
    dense = np.array([remap[c] for c in cls])
    return GaussianRegressor.fit(x, dense,
                                 avg_labels=np.asarray(avg_labels)[present],
                                 reg=reg)


def _execute(net: HierarchicalNetwork, x: torch.Tensor) -> np.ndarray:
    """One pass on the network's device; only the (N, out_dim) features
    come back to the host."""
    with torch.no_grad():
        return net(x).cpu().numpy()


@dataclasses.dataclass
class TrainConfig:
    """Sizes and switches of the synthetic training run (the JAX package's
    TrainConfig, field for field)."""

    num_faces: int = 150
    steps_per_face: int = 40
    disc_faces: int = 150
    disc_steps: int = 40
    eye_faces: int = 120
    eye_steps: int = 40
    age_samples: int = 12000
    # Eye-position jitter of the Z-frame age/race/gender training faces, in
    # Z-frame pixels / relative scale: the deployed heads see detected eye
    # positions, so the features must tolerate that misalignment.
    age_jitter_px: float = 4.0
    age_jitter_scale: float = 0.06
    pose_classes: int = 50
    seed: int = 12345600    # the reference's RNG seed (FaceDetectUpdated.py:146)
    top_dim: int = 20
    train_final_disc: bool = True
    # Real annotated photos (training.real) mixed into the synthetic pools:
    # fraction of face canvases / of background canvases drawn from real
    # photos. 0 disables (pure synthetic).
    real_frac: float = 0.22
    real_bg_frac: float = 0.30
    real_gt_file: str = ""   # "" = data/train_faces_gt.txt
    # Mined false-positive boxes: extra Disc background-class patches
    # centred on the production model's own real-photo FPs. mined_frac
    # scales the extra patch count relative to the background class size.
    # "" = no mining.
    mined_file: str = ""
    mined_frac: float = 0.5
    # Renderer attribute-cue version for all training datasets ("v2" is
    # the distribution the shipped networks were trained on).
    attr_cues: str = "v2"
    # Per-patch contrast normalization on the detection patch batches
    # (pose/disc); recorded in the manifest so the detector applies it too.
    contrast_normalize: bool = True
    # Step gains shipped in the manifest (DetectorConfig.pang_gain /
    # pos_gain / scale_gain).
    pang_gain: float = 0.25
    pos_gain: float = 0.65
    scale_gain: float = 1.0
    # Node type of the detection nets: "sfa" or "igsfa" (slow features +
    # whitened residual PCA per layer, models.moments.solve_igsfa_device).
    disc_node: str = "igsfa"
    # Decoder of the pose-refinement stages: "gaussian" (reference
    # semantics) or "ridge" (ops.ridge.RidgeRegressor).
    pose_head: str = "gaussian"
    pose_node: str = "sfa"
    eye_node: str = "sfa"
    # Multi-seed disc training: the disc nets are trained once per seed,
    # each candidate calibrated and scored (training.selection), and the
    # winner of the declared rule ships. () = one train on the base stream.
    disc_seeds: tuple = ()
    selection_scenes: int = 200
    selection_seed: int = 777       # training-side; 999 stays held out
    recall_floor: float = 0.73
    # Ladder + eye-gate calibration as the trainer's closing step
    # (training.calibration).
    calibrate: bool = True
    calib_scenes: int = 40
    calib_seed: int = 1234
    # Background cap of the calibrated ladder (0 = off): max cumulative
    # pre-NMS background windows/image.
    calib_bg_budget: float = 0.0
    # Small-scale real-anchor replicas in the calibration pool: target
    # inter-eye sizes in px, () = off.
    calib_anchor_small_ie: tuple = ()
    # Ladder rungs (serial indices) exempt from the bg-budget cap.
    calib_bg_protect: tuple = ()
    # High-frequency texture injection amplitude for all training patch
    # batches (0 = off).
    texture_noise: float = 0.0
    # Background-only texture injection for the disc datasets (0 = inherit
    # texture_noise).
    texture_noise_bg: float = 0.0
    # Fraction of the age-net training set drawn from real anchor faces
    # through the deploy-path Z-frame affine (0 = synthetic only).
    age_real_frac: float = 0.0
    # Basename of one anchor photo to hold out of the real age pool.
    age_real_exclude: str = ""
    # Training graph of the disc nets: "clustered" (10 graded classes,
    # within-class edges) or "serial" over the continuous centering
    # fraction (50 groups, neighbour edges).
    disc_graph: str = "clustered"


# (type, network, classifier, input_dim) rows of the produced pipeline;
# "None0" = reuse the previous features. Specialist pose nets: one xy net
# and one angle/scale net per iteration.
_STAGE_LAYOUT = [
    ("Disc1", "net_disc", "clf_Disc1", 9),
    ("PosX0", "net_pose0", "clf_PosX0", 10),
    ("PosY0", "None0", "clf_PosY0", 20),
    ("PAng0", "net_pose0as", "clf_PAng0", 20),
    ("Scale0", "None0", "clf_Scale0", 20),
    ("Disc3", "net_disc", "clf_Disc1", 9),
    ("PosX1", "net_pose1", "clf_PosX1", 20),
    ("PosY1", "None0", "clf_PosY1", 20),
    ("PAng1", "net_pose1as", "clf_PAng1", 20),
    ("Scale1", "None0", "clf_Scale1", 20),
    ("Disc5", "net_disc", "clf_Disc1", 9),
    ("PosX2", "net_pose1", "clf_PosX1", 20),
    ("PosY2", "None0", "clf_PosY1", 20),
    ("PAng2", "net_pose1as", "clf_PAng1", 20),
    ("Scale2", "None0", "clf_Scale1", 20),
    ("Disc7", "net_disc", "clf_Disc1", 9),
    ("Disc9", "net_disc_final", "clf_Disc9", 9),
    ("EyeLX", "net_eye", "clf_EyeLX", 12),
    ("EyeLY", "None0", "clf_EyeLY", 10),
    ("Age", "net_age", "clf_Age", 4),
    ("Race", "None0", "clf_Race", 5),
    ("Gender", "None0", "clf_Gender", 5),
]


def _phase_log(times: Dict[str, float]) -> str:
    """The per-network time line: render, fit, features, gaussian."""
    return ", ".join(f"{k} {times.get(k, 0.0):.3f} s"
                     for k in ("render", "fit", "features", "gaussian"))


def train_pipeline(out_dir: str, cfg: TrainConfig = TrainConfig(),
                   face_geom: NetGeometry = NetGeometry(),
                   verbose: bool = True, reuse: Sequence[str] = (),
                   data_mesh: int = 0,
                   device: Union[str, torch.device, None] = None) -> None:
    """Trains every network/classifier and writes the artifact directory,
    on ``device`` (default ``cuda``; raises without a card).

    ``reuse``: substrings of network names to load from ``out_dir``
    instead of retraining (e.g. ("pose", "eye") retrains only disc/age).
    ``data_mesh``: shard every network's moment accumulation over a data
    mesh of that many devices of ``device``'s kind (see
    :func:`train_network`); 0 = one device, and any N >= 1 builds a mesh,
    as in the JAX package.

    Every network logs ``[train] <name>: done (render .. s, fit .. s,
    features .. s, gaussian .. s)``, the host-clock seconds (device work
    included) of its dataset, its layer fits, its feature pass and its
    classifier fits.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    mesh = None
    if data_mesh:
        mesh = mesh_mod.make_mesh(data_mesh, ("data",), device=device)
        if verbose:
            print(f"[train] moment accumulation sharded over a "
                  f"{data_mesh}-device data mesh", flush=True)

    def _reusable(name):
        return any(r in name for r in reuse) and os.path.exists(
            os.path.join(out_dir, name + ".npz"))

    def sampler(*stream):
        return Sampler((cfg.seed,) + stream, device)

    real_source = None
    if cfg.real_frac > 0 or cfg.real_bg_frac > 0:
        from pyfaceanalysis_torch.training import real as real_mod
        if cfg.real_gt_file:
            real_source = real_mod.RealFaceSource(cfg.real_gt_file,
                                                  verbose=verbose,
                                                  device=device)
        else:
            real_source = real_mod.default_source(verbose=verbose,
                                                  device=device)
        if cfg.mined_file and real_source is not None:
            real_source.load_mined(cfg.mined_file, verbose=verbose)
    eye_geom = NetGeometry(Dx=8, Dy=8, Dang=0, mins=0.675, maxs=0.975,
                           subimage_width=64, subimage_height=64,
                           regression_width=64, regression_height=64)
    age_geom = NetGeometry(Dx=0, Dy=0, Dang=1.14, mins=1.14, maxs=1.14,
                           subimage_width=96, subimage_height=96,
                           regression_width=160, regression_height=160)
    nets: Dict[str, HierarchicalNetwork] = {}
    clfs: Dict[str, GaussianRegressor] = {}

    def log(msg):
        if verbose:
            print(msg, flush=True)

    def _load_reused(name, clf_names):
        nets[name] = artifacts.load_network(
            os.path.join(out_dir, name + ".npz")).to(device)
        for c in clf_names:
            clfs[c] = artifacts.load_classifier(
                os.path.join(out_dir, c + ".npz"))
        log(f"[train] {name}: reused existing artifacts")

    def _persist(name, clf_names):
        """Writes artifacts as soon as a net is trained: a crash in a later
        stage must not lose finished work (``reuse`` picks them up)."""
        artifacts.save_network(os.path.join(out_dir, name + ".npz"),
                               nets[name])
        for c in clf_names:
            artifacts.save_classifier(os.path.join(out_dir, c + ".npz"),
                                      clfs[c], clfs[c].input_dim)

    # --- pose nets: per-iteration specialists ------------------------------
    # xy nets sample the full grid offset envelope; angle/scale nets sample
    # narrow positional jitter (their stages run after the PosX/PosY
    # corrections).
    pose_plan = [
        ("net_pose0", (40.0, 20.0, 22.5), (1.0, 1.5), ("dx", "dy"), 0),
        ("net_pose0as", (12.0, 10.0, 22.5), (1.5, 1.0), ("ang", "scale"), 1),
        ("net_pose1", (14.0, 13.0, 21.0), (1.0, 1.5), ("dx", "dy"), 8),
        ("net_pose1as", (6.0, 6.0, 21.0), (1.5, 1.0), ("ang", "scale"), 9),
    ]
    clf_of = {"dx": "PosX", "dy": "PosY", "ang": "PAng", "scale": "Scale"}
    for name, ranges, weights, cols, kidx in pose_plan:
        it = "0" if "0" in name else "1"
        cnames = [f"clf_{clf_of[c]}{it}" for c in cols]
        if _reusable(name):
            _load_reused(name, cnames)
            continue
        times: Dict[str, float] = {}
        log(f"[train] {name}: rendering pose walks "
            f"(dx±{ranges[0]:g} dy±{ranges[1]:g} ang±{ranges[2]:g})...")
        with _timed(times, "render", device):
            x, labels = datasets.pose_dataset(
                sampler(kidx), cfg.num_faces, cfg.steps_per_face, face_geom,
                *ranges, real_source=real_source, real_frac=cfg.real_frac,
                contrast_normalize=cfg.contrast_normalize,
                attr_cues=cfg.attr_cues, texture_noise=cfg.texture_noise)
        net = builder.build_higsfa(64, top_dim=cfg.top_dim,
                                   node=cfg.pose_node)
        log(f"[train] {name}: fitting {len(net.specs)} layers "
            f"on {len(x)} patches")
        labk = np.stack([labels[c] for c in cols], axis=1)
        with _timed(times, "fit", device):
            net = train_network(net, x, graph="serial", labels=labk,
                                mesh=mesh, num_groups=cfg.pose_classes,
                                verbose=verbose,
                                label_weights=weights)
        nets[name] = net
        with _timed(times, "features", device):
            feats = _execute(net, x)
        with _timed(times, "gaussian", device):
            for c, cname in zip(cols, cnames):
                dim = 10 if cname == "clf_PosX0" else 20
                if cfg.pose_head == "ridge":
                    from pyfaceanalysis_torch.ops.ridge import RidgeRegressor
                    clfs[cname] = RidgeRegressor.fit(feats, labels[c], dim)
                else:
                    clfs[cname] = fit_regressor_bins(
                        feats, labels[c], dim, cfg.pose_classes)
        del x
        _persist(name, cnames)
        log(f"[train] {name}: done ({_phase_log(times)})")

    # --- eye net ------------------------------------------------------------
    if _reusable("net_eye"):
        _load_reused("net_eye", ["clf_EyeLX", "clf_EyeLY"])
    else:
        times = {}
        log("[train] net_eye: rendering eye walks...")
        with _timed(times, "render", device):
            x, labels = datasets.eye_dataset(
                sampler(4), cfg.eye_faces, cfg.eye_steps, eye_geom,
                real_source=real_source, real_frac=cfg.real_frac,
                attr_cues=cfg.attr_cues, texture_noise=cfg.texture_noise)
        net = builder.build_higsfa(64, top_dim=cfg.top_dim,
                                   node=cfg.eye_node)
        lab2 = np.stack([labels["x"], labels["y"]], axis=1)
        with _timed(times, "fit", device):
            net = train_network(net, x, graph="serial", labels=lab2,
                                mesh=mesh,
                                num_groups=cfg.pose_classes, verbose=verbose)
        nets["net_eye"] = net
        with _timed(times, "features", device):
            feats = _execute(net, x)
        with _timed(times, "gaussian", device):
            clfs["clf_EyeLX"] = fit_regressor_bins(feats, labels["x"], 12,
                                                   cfg.pose_classes)
            clfs["clf_EyeLY"] = fit_regressor_bins(feats, labels["y"], 10,
                                                   cfg.pose_classes)
        del x
        _persist("net_eye", ["clf_EyeLX", "clf_EyeLY"])
        log(f"[train] net_eye: done ({_phase_log(times)})")

    # --- age/race/gender net -------------------------------------------------
    if _reusable("net_age"):
        _load_reused("net_age", ["clf_Age", "clf_Race", "clf_Gender"])
    else:
        times = {}
        log("[train] net_age: rendering Z-frame faces...")
        n_real_age = (int(cfg.age_samples * cfg.age_real_frac)
                      if real_source is not None else 0)
        with _timed(times, "render", device):
            x, labels = datasets.age_dataset(
                sampler(5), cfg.age_samples - n_real_age,
                jitter_px=cfg.age_jitter_px,
                jitter_scale=cfg.age_jitter_scale, attr_cues=cfg.attr_cues,
                texture_noise=cfg.texture_noise)
            if n_real_age > 0:
                log(f"[train] net_age: + {n_real_age} real anchor Z-frames"
                    + (f" (excluding {cfg.age_real_exclude})"
                       if cfg.age_real_exclude else ""))
                xr, lr = real_source.sample_age_zframes(
                    cfg.seed + 17, n_real_age, exclude=cfg.age_real_exclude)
                x = torch.cat([x, xr], dim=0)
                labels = {k: np.concatenate([np.asarray(labels[k]), lr[k]])
                          for k in labels}
        # Linear wiring like the reference's linearPCANetworkU11L, trained
        # with a 3-label serial graph (age, race, gender) so the shared
        # feature space is attribute-discriminative.
        net = builder.build_pca_net(96, top_dim=cfg.top_dim, node="sfa")
        lab3 = np.stack([labels["age"], labels["race"], labels["gender"]],
                        axis=1)
        with _timed(times, "fit", device):
            net = train_network(net, x, graph="serial", labels=lab3,
                                mesh=mesh,
                                num_groups=20, verbose=verbose,
                                label_weights=(2.0, 1.0, 1.0))
        nets["net_age"] = net
        with _timed(times, "features", device):
            feats = _execute(net, x)
        with _timed(times, "gaussian", device):
            clfs["clf_Age"] = fit_regressor_bins(feats, labels["age"], 4,
                                                 num_classes=39)
            clfs["clf_Race"] = fit_regressor_classes(
                feats, (labels["race"] > 0).astype(int),
                np.array([-2.0, 2.0]), 5)
            clfs["clf_Gender"] = fit_regressor_classes(
                feats, (labels["gender"] > 0).astype(int),
                np.array([-1.0, 1.0]), 5)
        del x
        _persist("net_age", ["clf_Age", "clf_Race", "clf_Gender"])
        log(f"[train] net_age: done ({_phase_log(times)})")

    # --- discrimination nets -------------------------------------------------
    # Trained last: with disc_seeds set, every candidate is assembled into a
    # full pipeline (sharing the pose/eye/age nets above), calibrated and
    # scored.
    disc_names = ["net_disc"] + (["net_disc_final"] if cfg.train_final_disc
                                 else [])
    disc_clf_of = {"net_disc": "clf_Disc1", "net_disc_final": "clf_Disc9"}

    def _train_discs(streams, tag=""):
        """Trains the disc nets + classifiers on the given dataset streams;
        returns ({name: net}, {cname: clf}) without touching out_dir."""
        d_nets, d_clfs = {}, {}
        dstreams = {"net_disc": streams[0], "net_disc_final": streams[1]}
        for name in disc_names:
            cname = disc_clf_of[name]
            times = {}
            log(f"[train] {name}{tag}: rendering graded centering classes...")
            serial = cfg.disc_graph == "serial"
            with _timed(times, "render", device):
                out = datasets.disc_dataset(
                    sampler(*dstreams[name]), cfg.disc_faces, cfg.disc_steps,
                    face_geom, real_source=real_source,
                    real_frac=cfg.real_frac, real_bg_frac=cfg.real_bg_frac,
                    contrast_normalize=cfg.contrast_normalize,
                    mined_frac=cfg.mined_frac, attr_cues=cfg.attr_cues,
                    texture_noise=cfg.texture_noise,
                    texture_noise_bg=cfg.texture_noise_bg,
                    return_frac=serial)
            net = builder.build_higsfa(64, top_dim=cfg.top_dim,
                                       node=cfg.disc_node)
            with _timed(times, "fit", device):
                if serial:
                    x, cls, avg, frac = out
                    net = train_network(net, x, graph="serial", labels=frac,
                                        num_groups=50, mesh=mesh,
                                        verbose=verbose)
                else:
                    x, cls, avg = out
                    net = train_network(net, x, graph="clustered",
                                        labels=cls, mesh=mesh,
                                        verbose=verbose)
            d_nets[name] = net
            with _timed(times, "features", device):
                feats = _execute(net, x)
            with _timed(times, "gaussian", device):
                d_clfs[cname] = fit_regressor_classes(feats, cls, avg,
                                                      input_dim=9)
            del x, out
            log(f"[train] {name}{tag}: done ({_phase_log(times)})")
        if not cfg.train_final_disc:
            d_nets["net_disc_final"] = d_nets["net_disc"]
            d_clfs["clf_Disc9"] = d_clfs["clf_Disc1"]
        return d_nets, d_clfs

    def _final_cutoff(d_nets, d_clfs):
        """Final-gate estimate from converged-residual face patches: a
        fresh Gaussian soft-classifier has its own absolute output scale,
        so the reference's cut_offs_face do not transfer."""
        res = datasets.residual_dataset(
            sampler(6), max(cfg.disc_faces // 2, 8), 20, face_geom,
            real_source=real_source, real_frac=cfg.real_frac,
            contrast_normalize=cfg.contrast_normalize,
            attr_cues=cfg.attr_cues, texture_noise=cfg.texture_noise)
        net9 = d_nets["net_disc_final"]
        feats = _execute(net9, res)
        clf9 = d_clfs["clf_Disc9"].to(device)
        with torch.no_grad():
            vals = clf9.regression(torch.as_tensor(
                feats[:, :clf9.input_dim], device=device)).cpu().numpy()
        cut = float(min(max(np.quantile(vals, 0.90) * 1.15, 0.02), 0.9))
        log(f"[train] residual disc outputs: median={np.median(vals):.3f} "
            f"q90={np.quantile(vals, 0.90):.3f} -> last_cut_off={cut:.3f}")
        return cut

    def _write_dir(dest, d_nets, d_clfs, last_cut):
        """Writes a complete pipeline directory: shared nets/clfs + the
        given disc artifacts + pipeline file + manifest."""
        os.makedirs(dest, exist_ok=True)
        for name, net in {**nets, **d_nets}.items():
            artifacts.save_network(os.path.join(dest, name + ".npz"), net)
        for name, clf in {**clfs, **d_clfs}.items():
            artifacts.save_classifier(os.path.join(dest, name + ".npz"),
                                      clf, clf.input_dim)
        stages = tuple(StageSpec(t, n, c) for t, n, c, _ in _STAGE_LAYOUT)
        spec = PipelineSpec(face_geom, eye_geom, age_geom, stages)
        write_pipeline(os.path.join(dest, "Pipeline_tpu.txt"), spec)
        artifacts.save_manifest(
            dest, face_geom, eye_geom, age_geom,
            calibration={"last_cut_off_face": last_cut,
                         "detection_contrast_normalize":
                             bool(cfg.contrast_normalize),
                         "pang_gain": float(cfg.pang_gain),
                         "pos_gain": float(cfg.pos_gain),
                         "scale_gain": float(cfg.scale_gain)})

    def _calibrate_dir(dest):
        if not cfg.calibrate:
            return
        from pyfaceanalysis_torch.training import calibration
        log(f"[train] calibrating disc ladder + eye gate for {dest}...")
        t0 = time.perf_counter()
        result = calibration.calibrate_model(
            dest, scenes=cfg.calib_scenes, seed=cfg.calib_seed,
            bg_budget=cfg.calib_bg_budget,
            bg_protect=tuple(cfg.calib_bg_protect),
            anchor_small_ie=tuple(cfg.calib_anchor_small_ie),
            verbose=verbose, device=device)
        calibration.write_calibration(dest, result, verbose=verbose)
        log(f"[train] calibration: done in {time.perf_counter() - t0:.3f} s")

    if _reusable("net_disc"):
        _load_reused("net_disc", ["clf_Disc1"])
        if cfg.train_final_disc:
            _load_reused("net_disc_final", ["clf_Disc9"])
        else:
            nets["net_disc_final"] = nets["net_disc"]
            clfs["clf_Disc9"] = clfs["clf_Disc1"]
        _write_dir(out_dir, {}, {}, _final_cutoff(nets, clfs))
        _calibrate_dir(out_dir)
    elif cfg.disc_seeds:
        from pyfaceanalysis_torch.training import selection
        cand_dirs, scores = [], []
        for s in cfg.disc_seeds:
            tag = f" [disc seed {s}]"
            d_nets, d_clfs = _train_discs(((2, s), (3, s)), tag)
            cand = os.path.join(out_dir, f"_cand_disc_{s}")
            _write_dir(cand, d_nets, d_clfs, _final_cutoff(d_nets, d_clfs))
            _calibrate_dir(cand)
            log(f"[train] scoring candidate{tag} "
                f"({cfg.selection_scenes}-scene panel seed "
                f"{cfg.selection_seed} + anchors)...")
            sc = selection.score_candidate(
                cand, n_scenes=cfg.selection_scenes,
                panel_seed=cfg.selection_seed,
                anchors=(cfg.real_gt_file or "data/train_faces_gt.txt"),
                device=device)
            a = sc.get("anchors")
            log(f"[train] candidate{tag}: recall {sc['recall']:.4f} "
                f"FP/img {sc['fp_per_image']:.4f} anchors "
                + (f"{a['tp']}TP/{a['fp']}FP/{a['fn']}FN" if a else "-"))
            cand_dirs.append(cand)
            scores.append(sc)
        log("[train] disc-seed selection:")
        win = selection.select(scores, recall_floor=cfg.recall_floor,
                               verbose=verbose)
        if win is None:
            # every candidate misses a real face: fall back to the one
            # with the fewest anchor misses, then best panel recall.
            win = max(
                range(len(scores)),
                key=lambda i: (-scores[i].get("anchors", {}).get("fn", 9),
                               scores[i]["recall"]))
            log(f"[train] WARNING: every candidate eliminated on anchors; "
                f"falling back to least-bad candidate {win}")
        log(f"[train] selected disc seed {cfg.disc_seeds[win]} "
            f"(candidate {win}); promoting to {out_dir}")
        # TNS ship gate: the flagship photo stays out of training, mining,
        # calibration and selection, but the winner is measured on it.
        tns = selection.tns_gate(selection.score_tns(cand_dirs[win],
                                                     device=device))
        if tns["evaluated"]:
            r = tns["result"]
            log(f"[train] TNS ship gate on the winner: {r['tp']}TP/"
                f"{r['fp']}FP/{r['fn']}FN vs TP>={tns['min_tp']} "
                f"FP<={tns['max_fp']} -> "
                f"{'PASS' if tns['pass'] else 'FAIL'}")
            if not tns["pass"]:
                log("[train] WARNING: the selected winner FAILS the TNS "
                    "ship gate -- do NOT promote these artifacts to "
                    "production without a declared rule overriding it "
                    "(disc_selection.json carries the measurement)")
        for f in os.listdir(cand_dirs[win]):
            shutil.copy2(os.path.join(cand_dirs[win], f),
                         os.path.join(out_dir, f))
        with open(os.path.join(out_dir, "disc_selection.json"), "w") as f:
            json.dump({"seeds": list(cfg.disc_seeds), "scores": scores,
                       "selected": int(win),
                       "selected_seed": int(cfg.disc_seeds[win]),
                       "rule": "anchors fn==0 & tp>=3; recall>=floor -> "
                               "min fp; else max recall",
                       "recall_floor": cfg.recall_floor,
                       "tns_gate": tns}, f, indent=1)
    else:
        d_nets, d_clfs = _train_discs(((2,), (3,)))
        nets.update(d_nets)
        clfs.update(d_clfs)
        for name in disc_names:
            _persist(name, [disc_clf_of[name]])
        _write_dir(out_dir, {}, {}, _final_cutoff(nets, clfs))
        _calibrate_dir(out_dir)
    log(f"[train] wrote pipeline artifacts to {out_dir}")
