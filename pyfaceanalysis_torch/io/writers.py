"""Result writing in the reference's output format.

Output rows (FaceDetectUpdated.py:1258-1278): append-mode,
``x0, y0, x1, y1, angle, elx, ely, erx, ery[, age, race, gender, conf]``
with coordinates rounded to ints, angle/conf as floats, age as %2.1f;
``right_screen_eye_first`` swaps the eye pair.
"""

from __future__ import annotations


def write_detections(path: str, detections,
                     right_screen_eye_first: bool = False,
                     write_age_race_gender_confidence: bool = True) -> None:
    """Appends detection rows in the reference output format."""
    with open(path, "a") as fd:
        for d in detections:
            ints = [int(round(v)) for v in
                    (*d.box, *d.eye_left, *d.eye_right)]
            x0, y0, x1, y1, elx, ely, erx, ery = ints
            if right_screen_eye_first:
                elx, ely, erx, ery = erx, ery, elx, ely
            fd.write("%d, %d, %d, %d, %f, %d, %d, %d, %d"
                     % (x0, y0, x1, y1, d.angle, elx, ely, erx, ery))
            if write_age_race_gender_confidence and d.age is not None:
                fd.write(", %2.1f, %s, %s, %f"
                         % (d.age, d.race, d.gender, d.confidence))
            fd.write(" \n")
