"""Procedural face renderer, batched on the device.

Port of ``pyfaceanalysis_tpu.training.synth``. Canonical face geometry:
for a face of nominal size F (the side of a perfectly centred detection
box), with y pointing down,

    eyes   at (+-0.1752 F, -0.1989 F) relative to the face centre
    mouth  at (0, +0.1989 F)
    inter-eye distance E = 0.3504 F

Faces are shaded 2.5-D ellipsoid heads with multi-octave texture,
out-of-plane yaw, structured eyes / nose / mouth, facial hair, hair,
shoulders and collars, neighbour-head fragments and a photometric camera
pipeline. ``render_faces`` renders a batch of n canvases in one pass of
elementwise tensor ops (the JAX package vmaps ``render_face``); the values
are drawn from a :class:`~pyfaceanalysis_torch.training.sampler.Sampler`
in the JAX function's call order, one draw of shape (n, ...) per site.

All returned landmark attrs (``eye_l``, ``eye_r``, ``mouth``,
``face_size``, ``angle``) come from the ACTUAL rendered landmark positions
(after yaw projection and jitter), as an annotator's clicks would:
``face_size`` is ``inter_eye / 0.3504`` and ``angle`` the eye-line angle.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as nnf

from pyfaceanalysis_torch.training.sampler import Sampler

# Canonical layout constants (see module docstring).
EYE_X = 0.1752      # horizontal eye offset / F
EYE_Y = -0.1989     # vertical eye offset / F (up)
MOUTH_Y = 0.1989
INTER_EYE = 2 * EYE_X


def _value_noise(sampler: Sampler, n: int, hw: Tuple[int, int],
                 grids=(6, 12, 24, 48),
                 weights=(0.45, 0.27, 0.18, 0.10)) -> torch.Tensor:
    """(n, H, W) multi-octave value noise in ~[-1, 1]: random lattices
    upsampled bilinearly (half-pixel centres, edge texels held at the
    border, as ``jax.image.resize(..., "linear")`` upsamples)."""
    H, W = hw
    out = torch.zeros((n, H, W), dtype=torch.float32, device=sampler.device)
    for g, w in zip(grids, weights):
        lat = sampler.uniform((n, g, g), -1.0, 1.0)
        up = nnf.interpolate(lat[:, None], size=(H, W), mode="bilinear",
                             align_corners=False, antialias=False)[:, 0]
        out = out + w * up
    return out


def _unit_light(sampler: Sampler, n: int) -> torch.Tensor:
    """(n, 3) random light directions, biased to come from above/front."""
    az = sampler.uniform(n, -1.2, 1.2)
    el = sampler.uniform(n, 0.15, 1.1)
    lx = torch.sin(az) * torch.cos(el)
    ly = -torch.sin(el)               # from above (y down)
    lz = torch.cos(az) * torch.cos(el)
    return torch.stack([lx, ly, lz], dim=1)


def _per_face(value, n: int, device) -> torch.Tensor:
    """A python number or an (n,) / () tensor as an (n,) float32 tensor."""
    t = torch.as_tensor(value, dtype=torch.float32, device=device)
    return t.expand(n) if t.dim() == 0 else t.reshape(n)


def _grid(t):
    """Per-face (n,) values broadcast against (n, H, W) grids; python
    numbers pass through."""
    return t[:, None, None] if isinstance(t, torch.Tensor) else t


def render_faces(sampler: Sampler, n: int,
                 canvas_hw: Tuple[int, int] = (128, 128),
                 face_size=56.0, center=None, angle_deg=0.0,
                 with_face: bool = True, attr_cues: str = "v3"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Renders n faces (or pure backgrounds) into (n, H, W) canvases in
    [0, 1] on the sampler's device.

    ``face_size``, ``angle_deg`` and both ``center`` coordinates are
    python numbers or (n,) tensors; ``center`` None is the canvas centre.
    Returns (images, attrs): ``age`` (years, 16-58), ``race`` (-2 / +2),
    ``gender`` (-1 male / +1 female) as (n,), and the actual eye/mouth
    positions (n, 2), ``face_size`` and ``angle`` (n,) in canvas
    coordinates (zeros without a face).

    ``attr_cues`` ("v2" or "v3") selects the attribute-cue generation;
    the trainer renders v2, the distribution the shipped networks were
    trained on.
    """
    v3 = attr_cues == "v3"
    H, W = canvas_hw
    dev = sampler.device
    if center is None:
        center = (W / 2.0, H / 2.0)
    cx = _per_face(center[0], n, dev)
    cy = _per_face(center[1], n, dev)
    F = _per_face(face_size, n, dev)
    g = _grid

    # --- sampled identity attributes ---------------------------------------
    age = sampler.uniform(n, 16.0, 58.0)
    race = torch.where(sampler.bernoulli(n), 2.0, -2.0)
    gender = torch.where(sampler.bernoulli(n), 1.0, -1.0)
    tone = (0.52 + 0.15 * race / 2.0
            + 0.08 * sampler.normal(n))                     # skin luminance
    a_norm = (age - 37.0) / 21.0                            # [-1, 1]

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")

    # --- background: blend of scene styles + clutter ------------------------
    tex = _value_noise(sampler, n, (H, W))                   # cluttered
    foliage = 0.45 + 0.30 * torch.tanh(2.5 * tex)
    per = sampler.uniform(n, 0.05, 0.35)
    horiz = sampler.bernoulli(n)
    coord = torch.where(g(horiz), yy, xx)
    stripes = 0.45 + 0.13 * torch.sin(coord * g(per)) + 0.15 * tex
    gr = sampler.uniform((n, 4), -1.0, 1.0)
    grad = (0.55 + 0.22 * g(gr[:, 0]) + 0.20 * g(gr[:, 1]) * (yy / H - 0.5)
            + 0.12 * g(gr[:, 2]) * (xx / W - 0.5) + 0.05 * tex)
    flat = 0.42 + 0.25 * g(gr[:, 3]) + 0.03 * tex
    wsel = torch.softmax(sampler.normal((n, 4)) * 1.2, dim=-1)
    bg = (g(wsel[:, 0]) * foliage + g(wsel[:, 1]) * stripes
          + g(wsel[:, 2]) * grad + g(wsel[:, 3]) * flat)
    # clutter blobs (dark/bright patches: objects, shadows)
    bcx = sampler.uniform((n, 3, 2), 0.0, 1.0) * torch.tensor(
        [W, H], dtype=torch.float32, device=dev)
    bsz = sampler.uniform((n, 3), 0.08, 0.35)
    bto = sampler.uniform((n, 3), -0.35, 0.35)
    for i in range(3):
        r2 = (((xx - g(bcx[:, i, 0])) / g(bsz[:, i] * W)) ** 2
              + ((yy - g(bcx[:, i, 1])) / g(bsz[:, i] * H)) ** 2)
        bg = bg + g(bto[:, i]) * torch.exp(-r2)
    bg = bg + 0.03 * sampler.normal((n, H, W))

    def _camera(img):
        """Shared photometric pipeline: blur blend, gamma, contrast,
        vignette, sensor noise."""
        def roll5(a, k):
            return (a + torch.roll(a, k, -2) + torch.roll(a, -k, -2)
                    + torch.roll(a, k, -1) + torch.roll(a, -k, -1)) / 5.0
        blur = roll5(img, 1)
        blur2 = roll5(blur, 2)
        t = g(sampler.uniform(n, 0.0, 1.0))
        img = img * (1 - t) + torch.where(t < 0.5, blur, blur2) * t
        gamma = g(torch.exp(sampler.uniform(n, -0.35, 0.35)))
        img = torch.clamp(img, 0.0, 1.0) ** gamma
        cont = g(sampler.uniform(n, 0.75, 1.15))
        img = 0.5 + (img - 0.5) * cont
        vig = g(sampler.uniform(n, 0.0, 0.25))
        r2 = ((xx / W - 0.5) ** 2 + (yy / H - 0.5) ** 2) * 4.0
        img = img * (1.0 - vig * r2)
        img = img + 0.012 * sampler.normal((n, H, W))
        return torch.clamp(img, 0.0, 1.0)

    if not with_face:
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        return _camera(bg), {
            "age": age, "race": race, "gender": gender,
            "eye_l": torch.zeros((n, 2), device=dev),
            "eye_r": torch.zeros((n, 2), device=dev),
            "mouth": torch.zeros((n, 2), device=dev),
            "face_size": zeros, "angle": zeros,
        }

    # --- face-local frame (u right, v down, in units of F) -----------------
    rad = torch.deg2rad(_per_face(angle_deg, n, dev))
    c, s = torch.cos(rad), torch.sin(rad)
    dx, dy = xx - g(cx), yy - g(cy)
    u = (g(c) * dx + g(s) * dy) / g(F)
    v = (-g(s) * dx + g(c) * dy) / g(F)

    # Head ellipsoid semi-axes with identity jitter; age elongates slightly,
    # male faces are wider.
    ax = 0.335 * (1.0 + 0.05 * (gender < 0) + 0.05 * sampler.normal(n))
    ay = 0.465 * (1.0 + 0.08 * a_norm + 0.05 * sampler.normal(n))
    az = 0.38
    # Out-of-plane yaw: features shift horizontally by yaw * depth(u, v).
    yaw = sampler.uniform(n, -0.30, 0.30)

    e = (u / g(ax)) ** 2 + ((v + 0.02) / g(ay)) ** 2
    head = torch.sigmoid((1.0 - e) / 0.04)
    depth = az * torch.sqrt(torch.clamp(1.0 - e, 0.0, 1.0))   # ellipsoid z

    # --- Lambertian shading from ellipsoid normals -------------------------
    L = _unit_light(sampler, n)
    inv_d = 1.0 / torch.clamp(depth, min=0.05)
    nx_ = (u / g(ax) ** 2)
    ny_ = ((v + 0.02) / g(ay) ** 2)
    nz_ = inv_d * 0.0 + 1.0 / az                              # ~constant
    nrm = torch.sqrt(nx_ ** 2 + ny_ ** 2 + nz_ ** 2)
    ndl = (nx_ * g(L[:, 0]) + ny_ * g(L[:, 1]) + nz_ * g(L[:, 2])) / nrm
    shade = 0.62 + 0.38 * torch.clamp(ndl, -0.2, 1.0)

    # Skin: tone * shading + low-frequency texture + age wrinkles.
    skin_tex = _value_noise(sampler, n, (H, W), grids=(12, 24, 48),
                            weights=(0.4, 0.35, 0.25))
    wr_amp = 0.05 * torch.clamp(a_norm + 1.0, 0.0, 2.0) / 2.0
    skin = g(tone) * shade + 0.035 * skin_tex + g(wr_amp) * skin_tex
    skin = skin + g(0.04 * sampler.normal(n)) * v            # vert grade

    # --- facial features (positions yaw-projected + jittered) --------------
    jit = 0.010 * sampler.normal((n, 6))

    def proj_u(fu, fv):
        """Yaw projection: u' = u cos(yaw) + depth(u,v) sin(yaw)."""
        d = az * torch.sqrt(torch.clamp(
            1.0 - (fu / ax) ** 2 - ((fv + 0.02) / ay) ** 2, 0.0, 1.0))
        return fu * torch.cos(yaw) + d * torch.sin(yaw)

    eye_y_l = EYE_Y + jit[:, 1]
    eye_y_r = EYE_Y + jit[:, 2]
    eye_u_l = proj_u(-EYE_X + jit[:, 0], EYE_Y)
    eye_u_r = proj_u(EYE_X + jit[:, 0], EYE_Y)
    mouth_u = proj_u(0.0 + jit[:, 3], MOUTH_Y)
    mouth_v = MOUTH_Y + jit[:, 4]
    # Continuous age coordinate in [0, 1] over the 16-58y label range.
    age01 = torch.clamp((age - 16.0) / 42.0, 0.0, 1.0)
    # Female eyes render slightly larger (v3).
    eye_w = 0.055 * (1.0 + 0.15 * sampler.normal(n)
                     + (0.08 * (gender > 0) if v3 else 0.0))

    def blob(du, dv, su, sv):
        return torch.exp(-((u - g(du)) / g(su)) ** 2
                         - ((v - g(dv)) / g(sv)) ** 2)

    feats = torch.zeros_like(u)
    # Eyes: bright sclera band, dark iris, darker pupil, lid shadow above.
    iris_r = 0.024 * (1.0 + 0.2 * sampler.normal(n))
    eye_dark = 0.55 + 0.10 * sampler.normal(n)
    # Lid shadow deepens and the under-eye bag darkens with age (v3; v2
    # uses the fixed lid shade and no bag).
    if v3:
        lid_amp = 0.14 + 0.10 * age01 * torch.exp(0.30 * sampler.normal(n))
        bag_amp = 0.11 * age01 * torch.exp(0.30 * sampler.normal(n))
    else:
        lid_amp, bag_amp = 0.18, 0.0
    for eu, ev in ((eye_u_l, eye_y_l), (eye_u_r, eye_y_r)):
        sclera = blob(eu, ev, eye_w, 0.024)
        iris = blob(eu, ev, iris_r, iris_r)
        pupil = blob(eu, ev, iris_r * 0.45, iris_r * 0.45)
        lid = blob(eu, ev - 0.030, eye_w * 1.15, 0.012)
        bag = blob(eu, ev + 0.048, eye_w * 1.05, 0.017)
        feats = (feats + 0.22 * sclera - g(eye_dark) * iris - 0.25 * pupil
                 - g(lid_amp) * lid - g(bag_amp) * bag)
    # Brows: thicker/darker for male, slight angle jitter.
    brow_h = 0.014 + 0.012 * (gender < 0)
    brow_d = 0.22 + 0.12 * (gender < 0)
    brow_t = 0.025 * sampler.normal(n)
    # Female brows sit higher above the eye (v3).
    brow_lift = ((0.014 * (gender > 0) + 0.006 * sampler.normal(n))
                 if v3 else 0.0)
    for eu, sgn in ((eye_u_l, -1.0), (eye_u_r, 1.0)):
        bv = (EYE_Y - 0.085 - g(brow_lift)
              + g(brow_t) * sgn * (u - g(eu)) / 0.09)
        feats = feats - g(brow_d) * torch.exp(
            -((u - g(eu)) / 0.085) ** 2 - ((v - bv) / g(brow_h)) ** 2)
    # Nose: bridge highlight, side shadow (away from light), nostrils.
    nose_u = proj_u(0.0, 0.03)
    feats = feats + 0.10 * blob(nose_u, 0.02, 0.022, 0.095)
    shadow_side = torch.sign(L[:, 0] + 1e-6)
    feats = feats - 0.13 * blob(nose_u + shadow_side * 0.045, 0.05,
                                0.030, 0.075)
    feats = feats - 0.16 * (blob(nose_u - 0.030, 0.115, 0.016, 0.012)
                            + blob(nose_u + 0.030, 0.115, 0.016, 0.012))
    # Mouth: two lips, dark mid-line, optional smile + teeth.
    smile = sampler.uniform(n, 0.0, 1.0)
    open_m = sampler.uniform(n, 0.0, 1.0)
    # Smile curvature: mouth CORNERS bend up (smaller v) with smile.
    curve = g(-0.045 * smile) * (((u - g(mouth_u)) / 0.10) ** 2 - 0.5)
    mv = v - g(mouth_v) - curve
    lip_dark = (0.16 + 0.10 * (gender > 0)) * (1.0 - 0.12 * a_norm)
    feats = feats - g(lip_dark) * torch.exp(
        -((u - g(mouth_u)) / 0.10) ** 2 - (mv / 0.028) ** 2)
    feats = feats - 0.16 * torch.exp(-((u - g(mouth_u)) / 0.095) ** 2
                                     - (mv / 0.008) ** 2)
    teeth = 0.32 * smile * open_m
    feats = feats + g(teeth) * torch.exp(-((u - g(mouth_u)) / 0.070) ** 2
                                         - (mv / 0.013) ** 2)
    # Chin crease + forehead highlight + cheek modulation.
    feats = feats - 0.08 * blob(mouth_u, MOUTH_Y + 0.11, 0.06, 0.015)
    feats = feats + 0.07 * blob(proj_u(0.0, -0.30), -0.30, 0.22, 0.10)

    # Feature contrast fades slightly with age; a global per-face feature
    # amplitude (domain randomization).
    famp = torch.exp(sampler.uniform(n, -0.45, 0.30))
    feats = feats * g(famp) * g(1.0 - 0.10 * torch.clamp(a_norm, -1.0, 1.0))

    # --- localized wrinkle structures (older faces) -------------------------
    # Forehead lines, crow's feet, nasolabial folds: spatial structure,
    # amplitude-jittered so no single cue pins the age.
    age_w = ((age01 ** 1.6 if v3 else torch.clamp(a_norm, 0.0, 1.0))
             * torch.exp(0.35 * sampler.normal(n)))
    lines = 0.5 + 0.5 * torch.sin(v * 40.0 + 2.0 * skin_tex)
    forehead = (torch.exp(-((v + 0.26) / 0.06) ** 2)
                * torch.exp(-(u / 0.20) ** 2))
    crow = torch.zeros_like(u)
    for sgn in (-1.0, 1.0):
        crow = crow + blob(sgn * EYE_X * 1.62, EYE_Y + 0.012, 0.035, 0.05)
    naso = torch.zeros_like(u)
    for sgn in (-1.0, 1.0):
        d = u - sgn * (0.065 + 0.55 * (v - 0.02))
        band = (torch.sigmoid((v - 0.00) / 0.02)
                * torch.sigmoid((0.16 - v) / 0.03))
        naso = naso + torch.exp(-(d / 0.013) ** 2) * band
    # Jowl/cheek sag, growing with the same continuous age weight.
    jowl = torch.zeros_like(u)
    for sgn in (-1.0, 1.0):
        jowl = jowl + blob(sgn * 0.21, 0.27, 0.05, 0.055)
    feats = feats - g(age_w) * (0.11 * forehead * lines
                                + 0.10 * crow * lines
                                + 0.09 * naso
                                + (0.07 if v3 else 0.0) * jowl)

    # --- facial hair (some males): darken jaw/lip region --------------------
    has_beard = (gender < 0) & (sampler.uniform(n) < 0.40)
    beard_d = sampler.uniform(n, 0.15, 0.5)
    _value_noise(sampler, n, (H, W), grids=(24, 48),
                 weights=(0.5, 0.5))            # drawn, as in the JAX code
    jaw = (torch.sigmoid((v - 0.10) / 0.03)
           * torch.sigmoid((0.92 - e) / 0.05))
    stache = blob(mouth_u, mouth_v - 0.055, 0.09, 0.018)
    beard_mask = torch.clamp(jaw + 0.8 * stache, 0.0, 1.0) \
        * g(torch.where(has_beard, 1.0, 0.0))
    # carve out the mouth itself
    beard_mask = beard_mask * (1.0 - torch.exp(
        -((u - g(mouth_u)) / 0.10) ** 2 - (mv / 0.03) ** 2))

    # --- hair: textured cap with noisy hairline, covers sides/ears ---------
    has_hair = sampler.uniform(n) > 0.15
    hairline = sampler.uniform(n, -0.42, -0.22)
    # Male-pattern hairline recession with age (v3).
    if v3:
        hairline = hairline - (0.12 * age01 * (gender < 0)
                               * sampler.uniform(n, 0.3, 1.0))
    hair_tone = sampler.uniform(n, 0.04, 0.45)
    # Gray hair with age: gradual onset, extent jittered.
    gray = (torch.sigmoid((age - 47.0) / 5.0 if v3 else (age - 52.0) / 4.0)
            * sampler.uniform(n, 0.4, 1.0))
    hair_tone = hair_tone + gray * (0.78 - hair_tone)
    hair_tex = _value_noise(sampler, n, (H, W), grids=(12, 48),
                            weights=(0.5, 0.5))
    side_cov = sampler.uniform(n, 0.0, 1.0)
    e_hair = (u / g(ax * 1.16)) ** 2 + ((v + 0.05) / g(ay * 1.12)) ** 2
    cap = (torch.sigmoid((1.0 - e_hair) / 0.05)
           * torch.sigmoid((g(hairline) + 0.05 * hair_tex - v) / 0.035))
    sides = (torch.sigmoid((1.0 - e_hair) / 0.05)
             * torch.sigmoid((e - 0.72) / 0.10)
             * torch.sigmoid((0.1 - v) / 0.25) * g(side_cov))
    # Long hair framing the face down to the shoulders, gender-correlated.
    p_long = torch.where(gender > 0, 0.55, 0.08)
    has_long = sampler.uniform(n) < p_long
    long_mask = (torch.sigmoid((e - 0.85) / 0.10)
                 * torch.sigmoid((0.50 - v) / 0.10)
                 * torch.sigmoid((v + 0.30) / 0.12)
                 * torch.sigmoid((1.9 - e_hair) / 0.15)
                 * g(torch.where(has_long, 1.0, 0.0)))
    hair_mask = torch.clamp(cap + sides + long_mask, 0.0, 1.0) \
        * g(torch.where(has_hair, 1.0, 0.0))

    # --- shoulders / clothing / collar below the head ----------------------
    cloth_tone = sampler.uniform(n, 0.1, 0.7)
    cloth_tex = _value_noise(sampler, n, (H, W), grids=(10, 30),
                             weights=(0.6, 0.4))
    sh_y = sampler.uniform(n, 0.55, 0.75)
    sh_w = sampler.uniform(n, 0.7, 1.1)
    shoulders = torch.sigmoid(
        (v - (g(sh_y) + 0.25 * (u / g(sh_w)) ** 2)) / 0.04)
    cloth = g(cloth_tone) + 0.10 * cloth_tex
    has_collar = sampler.uniform(n) < 0.45
    collar = (torch.exp(-(torch.abs(u) / 0.10) ** 2)
              * torch.sigmoid((v - g(sh_y)) / 0.03)
              * torch.sigmoid((g(sh_y + 0.22) - v) / 0.05)
              * g(torch.where(has_collar, 1.0, 0.0)))
    cloth = cloth * (1.0 - 0.9 * collar) + 0.85 * collar

    # --- glasses on ~30% of faces ------------------------------------------
    has_glasses = sampler.uniform(n) < 0.3
    rr = g(sampler.uniform(n, 0.070, 0.10))

    def ring(du, dv):
        r = torch.sqrt(((u - g(du)) / 1.2) ** 2 + (v - g(dv)) ** 2)
        return torch.exp(-((r - rr) / 0.010) ** 2)

    bridge = torch.exp(-((u - g(nose_u)) / 0.045) ** 2
                       - ((v - EYE_Y) / 0.010) ** 2)
    glasses = (ring(eye_u_l, eye_y_l) + ring(eye_u_r, eye_y_r) + bridge) \
        * g(torch.where(has_glasses, 1.0, 0.0))

    # --- composite -----------------------------------------------------------
    face_val = skin + feats - 0.30 * glasses
    face_val = face_val * (1.0 - g(beard_d) * beard_mask)
    img = bg
    # neighbor-head fragment near the canvas edge (group-photo context)
    has_nb = sampler.uniform(n) < 0.35
    nb_side = torch.where(sampler.bernoulli(n), 1.0, -1.0)
    nb_u = nb_side * sampler.uniform(n, 0.85, 1.3)
    nb_v = g(sampler.uniform(n, -0.3, 0.4))
    e_nb = ((u - g(nb_u)) / g(ax * 1.1)) ** 2 + ((v - nb_v) / g(ay * 1.1)) ** 2
    nb_mask = torch.sigmoid((1.0 - e_nb) / 0.05) * \
        g(torch.where(has_nb, 1.0, 0.0))
    nb_tone = tone * (0.9 + 0.2 * sampler.normal(n))
    nb_face = (g(nb_tone) * shade
               - 0.15 * torch.exp(-((v - nb_v - EYE_Y * 0.8) / 0.04) ** 2)
               - 0.10 * torch.exp(-((v - nb_v - MOUTH_Y * 0.8) / 0.03) ** 2))
    # neighbor hair cap
    nb_hairm = torch.sigmoid(((nb_v - 0.30) - v) / 0.04)
    nb_face = nb_face * (1.0 - nb_hairm) + g(hair_tone) * nb_hairm
    img = img * (1.0 - nb_mask) + nb_mask * nb_face
    # torso, then neck, then head on top
    body = torch.clamp(shoulders - head, 0.0, 1.0)
    img = img * (1.0 - body) + cloth * body
    # Male necks render visibly wider (v3).
    neck_w = 0.14 * (1.0 + (0.20 * (gender < 0) if v3 else 0.0))
    neck = (torch.exp(-(torch.abs(u) / g(neck_w)) ** 3)
            * torch.sigmoid((v - 0.38) / 0.04)
            * torch.sigmoid((g(sh_y) + 0.12 - v) / 0.05) * (1.0 - head))
    neck_tone = g(tone) * 0.86 * shade      # chin shadow
    img = img * (1.0 - neck) + neck_tone * neck
    img = img * (1.0 - head) + face_val * head
    img = img * (1.0 - hair_mask) + \
        (g(hair_tone) + 0.12 * hair_tex) * hair_mask
    img = _camera(img)

    # --- ground-truth landmarks (annotation convention) ---------------------
    def to_canvas(fu, fv):
        return torch.stack([cx + (c * fu - s * fv) * F,
                            cy + (s * fu + c * fv) * F], dim=1)

    eye_l = to_canvas(eye_u_l, eye_y_l)
    eye_r = to_canvas(eye_u_r, eye_y_r)
    mouth = to_canvas(mouth_u, mouth_v)
    inter = torch.sqrt(torch.sum((eye_r - eye_l) ** 2, dim=1))
    f_eff = inter / INTER_EYE
    ang_eff = torch.rad2deg(torch.atan2(eye_r[:, 1] - eye_l[:, 1],
                                        eye_r[:, 0] - eye_l[:, 0]))
    attrs = {
        "age": age, "race": race, "gender": gender,
        "eye_l": eye_l, "eye_r": eye_r, "mouth": mouth,
        "face_size": f_eff, "angle": ang_eff,
    }
    return img, attrs


def render_face(sampler: Sampler, canvas_hw: Tuple[int, int] = (128, 128),
                face_size: float = 56.0, center=None, angle_deg: float = 0.0,
                with_face: bool = True, attr_cues: str = "v3"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One face: :func:`render_faces` with n = 1, the batch axis removed
    ((H, W) image, scalar and (2,) attrs)."""
    img, attrs = render_faces(sampler, 1, canvas_hw, face_size, center,
                              angle_deg, with_face, attr_cues)
    return img[0], {k: a[0] for k, a in attrs.items()}


def ou_walk(sampler: Sampler, n: int, lo: float, hi: float,
            step: float = 0.22, theta: float = 0.12) -> torch.Tensor:
    """Mean-reverting random walk of length n inside [lo, hi] (consecutive
    samples differ slowly), on the sampler's device."""
    mid, half = (lo + hi) / 2.0, (hi - lo) / 2.0
    eps = sampler.normal(n)
    x = torch.clamp(eps[0], -1.0, 1.0)
    xs = []
    for i in range(n):
        x = torch.clamp(x + theta * (0.0 - x) + step * eps[i], -1.0, 1.0)
        xs.append(x)
    return mid + half * torch.stack(xs)
