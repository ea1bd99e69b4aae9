"""Debug plotting: per-stage cascade state + final-detection figures.

Headless equivalents of the reference's matplotlib debug UI
(``create_network_plots`` / ``plot_current_subimage_coordinates_angles_
confidences`` face_analysis.py:673-981, and the show_final_detection figure
FaceDetectUpdated.py:1198-1221): instead of interactive windows, figures are
written to files (the build targets servers). matplotlib is imported lazily
and the functions no-op with a notice if it is missing. Host code on numpy
arrays, a copy of ``pyfaceanalysis_tpu.viz``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:                                  # pragma: no cover
        print("notice: matplotlib unavailable; skipping debug plots")
        return None


def plot_cascade_trace(image: np.ndarray, trace, stage_names: Sequence[str],
                       out_path: str, max_boxes: int = 400) -> Optional[str]:
    """3 x 6 matrix of per-stage box states (the reference's network plot).

    ``trace``: sequence of (boxes, angles, mask, conf) per stage, as returned
    by run_cascade(collect_trace=True).
    """
    plt = _plt()
    if plt is None:
        return None
    n = len(trace)
    rows, cols = 3, 6
    fig, axes = plt.subplots(rows, cols, figsize=(22, 11))
    fig.suptitle("Iterative Face Detection")
    axes = axes.ravel()
    for ax in axes:
        ax.axis("off")
    # First panel: the original image + initial grid footprint.
    axes[0].imshow(image, cmap="gray", origin="upper")
    axes[0].set_title("Original")
    axes[0].axis("on")
    for i, (boxes, angles, mask, conf) in enumerate(trace[:rows * cols - 1]):
        ax = axes[i + 1]
        ax.imshow(image, cmap="gray", origin="upper")
        ax.set_title(f"{stage_names[i]} ({int(np.asarray(mask).sum())})")
        ax.axis("on")
        b = np.asarray(boxes)[np.asarray(mask)][:max_boxes]
        for x0, y0, x1, y1 in b:
            ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0],
                    linewidth=0.6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_final_detections(image: np.ndarray, detections, out_path: str,
                          rgb: Optional[np.ndarray] = None
                          ) -> Optional[str]:
    """Final-detection figure: face boxes, eye markers, attribute labels
    (FaceDetectUpdated.py:1198-1221). ``rgb``: optional color copy of the
    image for display -- the reference loads an RGB copy purely for its
    overlays (FaceDetectUpdated.py:533-535) while detection runs on "L"."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(12, 9))
    fig.suptitle("Final face detections")
    if rgb is not None:
        ax.imshow(np.clip(rgb, 0.0, 1.0), origin="upper")
    else:
        ax.imshow(image, cmap="gray", origin="upper")
    for d in detections:
        x0, y0, x1, y1 = d.box
        ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], "w",
                linewidth=1.5)
        ax.plot([d.eye_left[0]], [d.eye_left[1]], "bo")
        ax.plot([d.eye_right[0]], [d.eye_right[1]], "yo")
        label = f"conf {1.0 - d.confidence:.2f}"
        if d.age is not None:
            label += f"\n{d.age:.0f}y {d.race} {d.gender}"
        ax.text(x0, max(y0 - 4, 0), label, color="yellow", fontsize=8)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
