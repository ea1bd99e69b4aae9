"""Trains the full pipeline model zoo into an artifact directory.

    python -m pyfaceanalysis_torch.apps.train --out_dir DIR [switches]

Port of ``pyfaceanalysis_tpu.apps.train`` (``pfa-train``): every switch
with the same default and the same ``--quick`` sizes, plus ``--device``.
Every network and classifier of the 22-stage pipeline is trained on
procedurally generated faces (training.synth), then the disc ladder and
eye gate are calibrated. The run is on the card unless ``--device=cpu``
is given; without a card it raises. ``--data_mesh=N`` (N >= 1) shards
every network's moment accumulation over a data mesh of N devices of that
kind (N copies of the CPU with ``--device=cpu``). ``--out_dir`` defaults
to ``SavedNetworksTPU``, the shipped artifacts, which a run overwrites:
name another directory.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def build_config(args):
    """The TrainConfig of parsed arguments (the JAX tool's mapping)."""
    from pyfaceanalysis_torch.training.trainer import TrainConfig

    real = dict(real_frac=args.real_frac, real_bg_frac=args.real_bg_frac,
                real_gt_file=args.real_gt_file,
                mined_file=args.mined_negatives,
                mined_frac=args.mined_frac, attr_cues=args.attr_cues,
                disc_node=args.disc_node,
                pose_node=args.pose_node, eye_node=args.eye_node,
                age_jitter_px=args.age_jitter_px,
                age_jitter_scale=args.age_jitter_scale,
                pose_classes=args.pose_classes,
                pose_head=args.pose_head,
                disc_seeds=tuple(int(s) for s in args.disc_seeds.split(",")
                                 if s),
                selection_scenes=args.selection_scenes,
                calibrate=not args.no_calibrate,
                calib_scenes=args.calib_scenes,
                calib_bg_budget=args.calib_bg_budget,
                calib_anchor_small_ie=tuple(
                    float(x) for x in args.calib_anchor_small_ie.split(",")
                    if x.strip()),
                calib_bg_protect=tuple(
                    int(x) for x in args.calib_bg_protect.split(",")
                    if x.strip()),
                texture_noise=args.texture_noise,
                texture_noise_bg=args.texture_noise_bg,
                disc_graph=args.disc_graph,
                age_real_frac=args.age_real_frac,
                age_real_exclude=args.age_real_exclude)
    if args.quick:
        real.update(calib_scenes=min(args.calib_scenes, 6),
                    selection_scenes=min(args.selection_scenes, 6))
        return TrainConfig(num_faces=24, steps_per_face=16, disc_faces=24,
                           disc_steps=16, eye_faces=20, eye_steps=16,
                           age_samples=400, seed=args.seed,
                           train_final_disc=not args.no_final_disc, **real)
    return TrainConfig(num_faces=args.num_faces,
                       steps_per_face=args.steps_per_face,
                       disc_faces=args.num_faces,
                       disc_steps=args.steps_per_face,
                       eye_faces=max(args.num_faces * 4 // 5, 8),
                       eye_steps=args.steps_per_face,
                       age_samples=args.age_samples, seed=args.seed,
                       train_final_disc=not args.no_final_disc, **real)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pyfaceanalysis_torch.apps.train",
        description="Train the face-analysis pipeline (synthetic data) "
                    "with the PyTorch port.")
    p.add_argument("--out_dir", default="SavedNetworksTPU")
    p.add_argument("--num_faces", type=int, default=150,
                   help="faces per pose-walk dataset")
    p.add_argument("--steps_per_face", type=int, default=40)
    p.add_argument("--age_samples", type=int, default=12000)
    p.add_argument("--age_jitter_px", type=float, default=4.0,
                   help="eye-position jitter of the age training frames "
                        "(Z px; production eye error is ~9)")
    p.add_argument("--age_jitter_scale", type=float, default=0.06)
    p.add_argument("--seed", type=int, default=12345600)
    p.add_argument("--quick", action="store_true",
                   help="tiny sizes for smoke testing")
    p.add_argument("--no_final_disc", action="store_true",
                   help="share one discriminator for all Disc stages")
    p.add_argument("--reuse", default="",
                   help="comma-separated net-name substrings to load from "
                        "out_dir instead of retraining (e.g. 'pose,eye')")
    p.add_argument("--real_frac", type=float, default=0.22,
                   help="fraction of face canvases drawn from real "
                        "annotated photos (training.real); 0 disables")
    p.add_argument("--real_bg_frac", type=float, default=0.30,
                   help="fraction of background canvases from real photos")
    p.add_argument("--real_gt_file", default="",
                   help="annotation file for real faces "
                        "(default data/train_faces_gt.txt)")
    p.add_argument("--pose_classes", type=int, default=50,
                   help="Gaussian-classifier bins of the pose/eye "
                        "regressors (reference ships 50)")
    p.add_argument("--disc_node", default="igsfa", choices=["sfa", "igsfa"])
    p.add_argument("--pose_node", default="sfa", choices=["sfa", "igsfa"])
    p.add_argument("--eye_node", default="sfa", choices=["sfa", "igsfa"])
    p.add_argument("--pose_head", default="gaussian",
                   choices=["gaussian", "ridge"],
                   help="pose-stage decoder: reference Gaussian soft "
                        "regression, or a ridge readout (recalibrate gates "
                        "after switching)")
    p.add_argument("--mined_negatives", default="",
                   help="mined false-positive box file: extra Disc "
                        "background negatives on the model's own FPs")
    p.add_argument("--mined_frac", type=float, default=0.5,
                   help="extra mined negatives as a fraction of the Disc "
                        "background class size")
    p.add_argument("--attr_cues", default="v2", choices=["v2", "v3"],
                   help="renderer attribute-cue version for training data "
                        "(v2 = shipped-model provenance)")
    p.add_argument("--disc_seeds", default="",
                   help="comma-separated dataset seeds for multi-seed disc "
                        "training; each candidate is ladder-calibrated and "
                        "scored on a training-side panel + the real "
                        "anchors, and the declared-rule winner is shipped. "
                        "'' = single train")
    p.add_argument("--selection_scenes", type=int, default=48,
                   help="panel size for multi-seed disc selection")
    p.add_argument("--no_calibrate", action="store_true",
                   help="skip the automatic disc-ladder + eye-gate "
                        "calibration (training.calibration) after training")
    p.add_argument("--calib_scenes", type=int, default=40)
    p.add_argument("--texture_noise", type=float, default=0.0,
                   help="high-frequency texture injection amplitude for "
                        "training patches (0 = off)")
    p.add_argument("--texture_noise_bg", type=float, default=0.0,
                   help="background-only texture injection amplitude for "
                        "the disc datasets (0 = inherit --texture_noise)")
    p.add_argument("--disc_graph", default="clustered",
                   choices=["clustered", "serial"],
                   help="disc training graph: reference-style 10-class "
                        "clustered, or serial over the continuous "
                        "centering fraction")
    p.add_argument("--age_real_frac", type=float, default=0.0,
                   help="fraction of the age-net training set drawn from "
                        "real anchor faces via the deploy-path Z-frame "
                        "affine (0 = synthetic only)")
    p.add_argument("--age_real_exclude", default="",
                   help="anchor photo basename to hold out of the real "
                        "age pool (leave-one-photo-out measurement)")
    p.add_argument("--calib_bg_budget", type=float, default=0.0,
                   help="background cap of the calibrated disc ladder "
                        "(max cumulative pre-NMS background windows/image; "
                        "0 = off)")
    p.add_argument("--calib_anchor_small_ie", default="",
                   help="comma-separated target inter-eye sizes (px): adds "
                        "downscaled real-anchor replicas to the calibration "
                        "pool")
    p.add_argument("--calib_bg_protect", default="",
                   help="comma-separated ladder serial indices exempt from "
                        "the bg-budget cap")
    p.add_argument("--data_mesh", type=int, default=0,
                   help="shard every network's moment accumulation over an "
                        "N-device data mesh (0 = one device)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="device to train on (default cuda; raises without "
                        "a card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from pyfaceanalysis_torch.training.trainer import train_pipeline

    cfg = build_config(args)
    t0 = time.time()
    reuse = tuple(s for s in args.reuse.split(",") if s)
    train_pipeline(args.out_dir, cfg, reuse=reuse, data_mesh=args.data_mesh,
                   device=args.device)
    print(f"training finished in {time.time() - t0:.1f}s -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
