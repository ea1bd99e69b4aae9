"""Real-photo training canvases: annotated faces + hard-negative crops.

Port of ``pyfaceanalysis_tpu.training.real``. The few annotated real
photographs serve as anchors: each annotated face is warped (rotation +
scale, the affine family of ops.patches) into training canvases at many
sizes, angles and mirrorings and mixed into the synthetic pools
(training.datasets); non-face regions of the same photos become
hard-negative background canvases for the Disc classes.

The canvases carry the same attrs as ``training.synth.render_faces``,
landmarks derived from the annotation through the exact warp affine, so the
label math of training.datasets applies unchanged. The photo stacks live on
the source's device; box geometry is drawn on the host from
``np.random.RandomState(seed)``, as in the JAX package, so both packages
sample the same boxes for one seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pyfaceanalysis_torch.config import resolve_device
from pyfaceanalysis_torch.training.sampler import Sampler
from pyfaceanalysis_torch.training.synth import INTER_EYE

DEFAULT_GT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data",
    "train_faces_gt.txt")


class RealFaceSource:
    """Loads annotated photos once (on ``device``, default ``cuda``;
    mirrored copies included) and samples face / background canvases on
    demand."""

    def __init__(self, gt_file: str = DEFAULT_GT, verbose: bool = True,
                 mined_file: str = "",
                 device: Union[str, torch.device, None] = None):
        from pyfaceanalysis_torch.io.images import load_image
        from pyfaceanalysis_torch.io.writers import load_true_coordinates

        self.device = resolve_device(device)
        filenames, coords = load_true_coordinates("", gt_file)
        base_images: List[np.ndarray] = []
        img_of_face: List[int] = []
        path_to_idx: Dict[str, int] = {}
        for fn in filenames:
            if fn not in path_to_idx:
                arr, _ = load_image(fn, prescale_size=None)
                path_to_idx[fn] = len(base_images)
                base_images.append(arr)
            img_of_face.append(path_to_idx[fn])

        # Aliasing variants: the detector prescales big photos with NEAREST;
        # decimate-then-replicate reproduces that aliasing at unchanged
        # coordinates.
        def alias(a: np.ndarray, f: int) -> np.ndarray:
            d = np.repeat(np.repeat(a[::f, ::f], f, axis=0), f, axis=1)
            return d[: a.shape[0], : a.shape[1]]

        images: List[np.ndarray] = []
        for a in base_images:
            for f in (1, 2, 3):
                images.append(a if f == 1 else alias(a, f))

        H = max(a.shape[0] for a in images)
        W = max(a.shape[1] for a in images)
        stack = np.zeros((2 * len(images), H, W), np.float32)
        valid = np.zeros((2 * len(images), H, W), np.float32)
        sizes = np.zeros((len(images), 2), np.int64)
        for i, a in enumerate(images):
            stack[i, :a.shape[0], :a.shape[1]] = a
            # mirrored copy (flip x within the valid region)
            stack[len(images) + i, :a.shape[0], :a.shape[1]] = a[:, ::-1]
            valid[i, :a.shape[0], :a.shape[1]] = 1.0
            valid[len(images) + i, :a.shape[0], :a.shape[1]] = 1.0
            sizes[i] = a.shape
        self._stack = torch.from_numpy(stack).to(self.device)
        self._valid = torch.from_numpy(valid).to(self.device)
        self._sizes = sizes
        self._n_images = len(images)

        # Face records: (img_idx, eye_l, eye_r, mouth), per aliasing
        # variant, each with a mirrored twin.
        faces = []
        for j, row in enumerate(coords):
            bi = img_of_face[j]
            el = row[0:2].copy()
            er = row[2:4].copy()
            mo = row[6:8].copy()
            w = sizes[bi * 3][1]

            def flip(p, w=w):
                return np.array([w - 1.0 - p[0], p[1]])
            for v in range(3):
                ii = bi * 3 + v
                faces.append((ii, el, er, mo))
                # mirroring swaps left and right eyes
                faces.append((self._n_images + ii, flip(er), flip(el),
                              flip(mo)))
        self._faces = faces
        # Inflated face boxes per unmirrored variant (background rejection).
        self._face_boxes: Dict[int, List[Tuple[float, float, float]]] = {}
        for (ii, el, er, mo) in faces[::2]:
            cx = (el[0] + er[0]) / 2.0
            cy = ((el[1] + er[1]) / 2.0 + mo[1]) / 2.0
            F = float(np.hypot(*(er - el))) / INTER_EYE
            self._face_boxes.setdefault(ii, []).append((cx, cy, F))
        if verbose:
            print(f"[real] {len(coords)} annotated faces over "
                  f"{self._n_images} photos ({gt_file})")

        # filename -> base-image index (full path and basename keys), for
        # mined hard-negative box resolution.
        self._path_to_base: Dict[str, int] = dict(path_to_idx)
        for fn, bi in list(path_to_idx.items()):
            self._path_to_base.setdefault(os.path.basename(fn), bi)
        self._base_name: Dict[int, str] = {
            bi: os.path.basename(fn) for fn, bi in path_to_idx.items()}
        self._mined = np.zeros((0, 5), np.float32)  # (bi, cx, cy, side, ang)
        if mined_file:
            self.load_mined(mined_file, verbose=verbose)

    @property
    def num_faces(self) -> int:
        return len(self._faces)

    @property
    def num_mined(self) -> int:
        return len(self._mined)

    def _extract(self, stack, boxes, angs, hw, method, img_idx):
        from pyfaceanalysis_torch.ops.patches import extract_patches_rotate
        dev = self.device
        return extract_patches_rotate(
            stack, torch.as_tensor(boxes, device=dev),
            torch.as_tensor(angs, device=dev), hw, method=method,
            image_idx=torch.as_tensor(img_idx, device=dev))

    def load_mined(self, mined_file: str, verbose: bool = True) -> None:
        """Loads mined hard-negative boxes: lines of ``filename x0 y0 x1 y1
        angle`` in full-resolution photo coordinates. Boxes on photos absent
        from the annotation file are skipped (their pixels are not in the
        stack)."""
        rows = []
        skipped = 0
        with open(mined_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                fn = parts[0]
                bi = self._path_to_base.get(
                    fn, self._path_to_base.get(os.path.basename(fn)))
                if bi is None:
                    skipped += 1
                    continue
                x0, y0, x1, y1, ang = map(float, parts[1:6])
                rows.append((bi, (x0 + x1) / 2.0, (y0 + y1) / 2.0,
                             abs(x1 - x0) + 1.0, ang))
        self._mined = np.asarray(rows, np.float32).reshape(-1, 5)
        if verbose:
            msg = f"[real] {len(rows)} mined hard-negative boxes"
            if skipped:
                msg += f" ({skipped} skipped: photo not in stack)"
            print(msg)

    def sample_mined_patches(self, seed: int, n: int,
                             patch_hw: Tuple[int, int] = (64, 64)
                             ) -> torch.Tensor:
        """(n, h, w) net-geometry patches centred (with jitter) on mined
        false-positive boxes: scale x/1.2, +-12% shift, +-8 deg, aliasing
        variants and mirroring, as the face sampler does."""
        if len(self._mined) == 0:
            raise ValueError("no mined boxes loaded (load_mined)")
        rng = np.random.RandomState(seed + 13)
        m = self._mined
        idx = rng.randint(0, len(m), n)
        bi = m[idx, 0].astype(np.int64)
        ii = bi * 3 + rng.randint(0, 3, n)           # aliasing variant
        mirror = rng.randint(0, 2, n)
        side = m[idx, 3] * np.exp(rng.uniform(-0.18, 0.18, n))
        cx = m[idx, 1] + rng.uniform(-0.12, 0.12, n) * side
        cy = m[idx, 2] + rng.uniform(-0.12, 0.12, n) * side
        ang = m[idx, 4] + rng.uniform(-8.0, 8.0, n)
        w = self._sizes[ii, 1].astype(np.float64)
        cx = np.where(mirror, w - 1.0 - cx, cx)
        ang = np.where(mirror, -ang, ang)
        img_idx = (ii + mirror * self._n_images).astype(np.int32)
        boxes = np.stack([cx - (side - 1.0) / 2.0, cy - (side - 1.0) / 2.0,
                          cx + (side - 1.0) / 2.0, cy + (side - 1.0) / 2.0],
                         axis=1).astype(np.float32)
        return self._extract(self._stack, boxes, ang.astype(np.float32),
                             patch_hw, "nearest", img_idx)

    def sample_faces(self, seed: int, n: int,
                     canvas_hw: Tuple[int, int] = (240, 240),
                     face_size_range: Tuple[float, float] = (40.0, 110.0),
                     angle_range: float = 22.5, sampler=None):
        """n canvases with a real face at (random size, angle, identity,
        mirror). Returns (imgs (n, H, W) on the device, attrs dict of numpy
        arrays) in the training.synth attrs convention. The box geometry
        comes from ``RandomState(seed)``; the fill and photometric jitter
        from ``sampler`` (default: a :class:`Sampler` seeded with
        ``seed ^ 0x5eed``)."""
        Hc, Wc = canvas_hw
        rng = np.random.RandomState(seed)
        idx = rng.randint(0, len(self._faces), n)
        F_dst = rng.uniform(*face_size_range, n)
        th_dst = rng.uniform(-angle_range, angle_range, n)

        boxes = np.zeros((n, 4), np.float32)
        angs = np.zeros(n, np.float32)
        img_idx = np.zeros(n, np.int32)
        eye_l = np.zeros((n, 2), np.float32)
        eye_r = np.zeros((n, 2), np.float32)
        mouth = np.zeros((n, 2), np.float32)
        for i in range(n):
            ii, el, er, mo = self._faces[idx[i]]
            inter = np.hypot(*(er - el))
            F_src = inter / INTER_EYE
            th_src = np.degrees(np.arctan2(er[1] - el[1], er[0] - el[0]))
            # annotation-convention face centre: mid(mid_eyes, mouth)
            fc = np.array([((el[0] + er[0]) / 2.0 + mo[0]) / 2.0,
                           ((el[1] + er[1]) / 2.0 + mo[1]) / 2.0])
            s_box = Wc * F_src / F_dst[i]          # source px per canvas
            a = th_src - th_dst[i]                  # warp rotation
            boxes[i] = [fc[0] - s_box / 2.0, fc[1] - s_box / 2.0,
                        fc[0] + s_box / 2.0 - 1.0, fc[1] + s_box / 2.0 - 1.0]
            angs[i] = a
            img_idx[i] = ii
            # affine: canvas = R(-a) . (p - fc) * (Wc / s_box) + center
            ca, sa = np.cos(np.radians(-a)), np.sin(np.radians(-a))
            R = np.array([[ca, -sa], [sa, ca]])
            k = Wc / s_box
            cc = np.array([Wc / 2.0, Hc / 2.0])
            eye_l[i] = R @ (el - fc) * k + cc
            eye_r[i] = R @ (er - fc) * k + cc
            mouth[i] = R @ (mo - fc) * k + cc

        imgs = self._extract(self._stack, boxes, angs, (Hc, Wc), "bilinear",
                             img_idx)
        # Fill out-of-photo regions (the warp leaves them 0) with neutral
        # gray + noise instead of hard black wedges.
        if sampler is None:
            sampler = Sampler(seed ^ 0x5eed, self.device)
        mask = self._extract(self._valid, boxes, angs, (Hc, Wc), "bilinear",
                             img_idx)
        fill = (sampler.uniform((n, 1, 1), 0.2, 0.7)
                + 0.05 * sampler.normal(tuple(imgs.shape)))
        imgs = imgs * mask + fill * (1.0 - mask)
        # photometric jitter: gamma + noise
        gamma = torch.exp(sampler.uniform((n, 1, 1), -0.3, 0.3))
        imgs = torch.clamp(imgs, 0.0, 1.0) ** gamma
        imgs = torch.clamp(imgs + 0.012 * sampler.normal(tuple(imgs.shape)),
                           0.0, 1.0)

        inter = np.hypot(eye_r[:, 0] - eye_l[:, 0], eye_r[:, 1] - eye_l[:, 1])
        attrs = {
            "eye_l": eye_l, "eye_r": eye_r, "mouth": mouth,
            "face_size": (inter / INTER_EYE).astype(np.float32),
            "angle": np.degrees(np.arctan2(
                eye_r[:, 1] - eye_l[:, 1],
                eye_r[:, 0] - eye_l[:, 0])).astype(np.float32),
            # attribute labels unknown for generic annotations (NaN, so
            # attribute training can filter them out)
            "age": np.full(n, np.nan, np.float32),
            "race": np.full(n, np.nan, np.float32),
            "gender": np.full(n, np.nan, np.float32),
        }
        return imgs, attrs

    def sample_backgrounds(self, seed: int, n: int,
                           canvas_hw: Tuple[int, int] = (240, 240)
                           ) -> torch.Tensor:
        """n face-free crops (hard negatives: foliage, shelves, clothing),
        rejected while they overlap an annotated face inflated to 1.8x its
        nominal size."""
        Hc, Wc = canvas_hw
        rng = np.random.RandomState(seed + 7)
        boxes = np.zeros((n, 4), np.float32)
        img_idx = np.zeros(n, np.int32)
        i = 0
        tries = 0
        while i < n and tries < n * 200:
            tries += 1
            ii = rng.randint(0, self._n_images)
            ih, iw = self._sizes[ii]
            side = rng.uniform(60.0, min(ih, iw) * 0.6)
            cx = rng.uniform(side / 2, iw - side / 2)
            cy = rng.uniform(side / 2, ih - side / 2)
            bad = False
            for (fx, fy, F) in self._face_boxes.get(ii, []):
                r = 0.9 * F + side / 2.0           # inflated 1.8x face
                if abs(cx - fx) < r and abs(cy - fy) < r:
                    bad = True
                    break
            if bad:
                continue
            mirror = rng.randint(0, 2)
            if mirror:
                cx = iw - 1.0 - cx
            boxes[i] = [cx - side / 2, cy - side / 2,
                        cx + side / 2 - 1.0, cy + side / 2 - 1.0]
            img_idx[i] = ii + mirror * self._n_images
            i += 1
        if i < n:          # pathological annotation: fall back to repeats
            boxes[i:] = boxes[:max(i, 1)][np.arange(n - i) % max(i, 1)]
            img_idx[i:] = img_idx[:max(i, 1)][np.arange(n - i) % max(i, 1)]
        angs = rng.uniform(-20.0, 20.0, n).astype(np.float32)
        return self._extract(self._stack, boxes, angs, (Hc, Wc), "bilinear",
                             img_idx)

    def sample_age_zframes(self, seed: int, n: int,
                           attrs_file: str = "",
                           eye_jitter_frac: float = 0.08,
                           exclude: str = ""):
        """n deploy-identical 96x96 age-head input patches of the real
        anchor faces and their true (age, race, gender) labels.

        The extraction is the detector's attribute path (engine.heads: eyes
        -> "eyes_inferred-mouth_areaZ" frame -> composed-affine gather ->
        contrast enhancement), driven by the annotated eyes perturbed by
        ``eye_jitter_frac`` x inter-eye per eye. ``exclude`` drops one photo
        (basename). Labels come from ``attrs_file`` (``basename age race
        gender`` lines; default ``data/anchor_attrs.txt``), ages clipped to
        57.8. Returns (flat (n, 9216) patches on the device, labels dict of
        numpy arrays)."""
        from pyfaceanalysis_torch import normalization
        from pyfaceanalysis_torch.engine.heads import Z_SIZE, _sample_age_patches
        from pyfaceanalysis_torch.ops.contrast import contrast_enhance_patches

        if not attrs_file:
            attrs_file = os.path.join(os.path.dirname(DEFAULT_GT),
                                      "anchor_attrs.txt")
        attr_of: Dict[str, Tuple[float, float, float]] = {}
        with open(attrs_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, age_s, race_s, gender_s = line.split()
                attr_of[name] = (
                    min(float(age_s), 57.8),
                    2.0 if race_s.lower() == "white" else -2.0,
                    1.0 if gender_s.lower() == "female" else -1.0)

        usable = []
        for fi, (ii, el, er, mo) in enumerate(self._faces):
            base = (ii % self._n_images) // 3
            name = self._base_name.get(base, "")
            if name in attr_of and name != exclude:
                usable.append((fi, attr_of[name]))
        if not usable:
            raise ValueError(f"no usable anchor faces ({attrs_file}, "
                             f"exclude={exclude!r})")

        rng = np.random.RandomState(seed + 31)
        pick = rng.randint(0, len(usable), n)
        centers = np.zeros((n, 2), np.float32)
        angles = np.zeros(n, np.float32)
        sfs = np.zeros(n, np.float32)
        img_idx = np.zeros(n, np.int32)
        age = np.zeros(n, np.float32)
        race = np.zeros(n, np.float32)
        gender = np.zeros(n, np.float32)
        for i in range(n):
            fi, (a, r, g) = usable[pick[i]]
            ii, el, er, _mo = self._faces[fi]
            inter = float(np.hypot(*(er - el)))
            jr = eye_jitter_frac * inter
            th = rng.uniform(0.0, 2 * np.pi, 2)
            rad = jr * np.sqrt(rng.uniform(0.0, 1.0, 2))
            elj = el + rad[0] * np.array([np.cos(th[0]), np.sin(th[0])])
            erj = er + rad[1] * np.array([np.cos(th[1]), np.sin(th[1])])
            fp = normalization.frame_params(
                [elj[0], elj[1], erj[0], erj[1], 0.0, 0.0],
                normalization_method="eyes_inferred-mouth_areaZ",
                centering_mode="mid_eyes_inferred-mouth",
                rotation_mode="EyeLineRotation",
                out_size=(Z_SIZE[1], Z_SIZE[0]))
            centers[i] = [fp.center_x, fp.center_y]
            angles[i] = fp.angle_deg
            sfs[i] = fp.sf
            img_idx[i] = ii
            age[i], race[i], gender[i] = a, r, g
        dev = self.device
        patches = _sample_age_patches(
            self._stack, torch.as_tensor(centers, device=dev),
            torch.as_tensor(angles, device=dev),
            torch.as_tensor(sfs, device=dev),
            torch.as_tensor(img_idx, device=dev))
        flat = contrast_enhance_patches(patches.reshape(n, -1),
                                        obj_avg=0.0, obj_std=0.16)
        return flat, {"age": age, "race": race, "gender": gender}


def default_source(verbose: bool = True,
                   device: Union[str, torch.device, None] = None
                   ) -> Optional[RealFaceSource]:
    """The repository's annotated-real-face source, or None when the
    annotation file or one of its photos is missing."""
    try:
        return RealFaceSource(DEFAULT_GT, verbose=verbose, device=device)
    except OSError as e:
        if verbose:
            print(f"[real] no real-face pool ({e})")
        return None
