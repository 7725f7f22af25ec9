"""ArUco tag tracker.

Port of `uvio_tpu/frontend/aruco.py`, the equivalent of
`ov_core/src/track/TrackAruco.{h,cpp}`: detect fiducial markers with
OpenCV's aruco module and emit their corners as persistent-ID features (tag id -> 4 stable feature ids), with optional
half-resolution detection (`downsize_aruco`).

Host-side by design: tag detection is a sparse, branchy CPU task the
reference also runs on CPU; its output feeds the same (ids, uvs)
interface as the KLT/descriptor trackers. Tag ids are offset into a
dedicated id range so they never collide with natural-feature ids,
mirroring the reference's `max_features` offsetting.

`cv2` is imported inside the functions; without it they raise its
`ImportError`, and nothing falls back.
"""

from __future__ import annotations

import numpy as np

ARUCO_ID_BASE = 1_000_000  # tag feature ids: BASE + 4*tag_id + corner


class ArucoTracker:
    def __init__(self, dictionary: str = "DICT_6X6_250", downsize: bool = False):
        import cv2

        self._cv2 = cv2
        d = getattr(cv2.aruco, dictionary)
        self._detector = cv2.aruco.ArucoDetector(
            cv2.aruco.getPredefinedDictionary(d), cv2.aruco.DetectorParameters()
        )
        self.downsize = downsize

    def feed(self, t: float, img: np.ndarray):
        """Returns (ids (N,), uvs (N,2)) — 4 corner features per tag."""
        cv2 = self._cv2
        im = img.astype(np.uint8) if img.dtype != np.uint8 else img
        scale = 1.0
        if self.downsize:
            im = cv2.pyrDown(im)
            scale = 2.0
        corners, tag_ids, _ = self._detector.detectMarkers(im)
        ids, uvs = [], []
        if tag_ids is not None:
            for tag, quad in zip(tag_ids.reshape(-1), corners):
                for c in range(4):
                    ids.append(ARUCO_ID_BASE + 4 * int(tag) + c)
                    uvs.append(quad.reshape(4, 2)[c] * scale)
        if not ids:
            return np.zeros(0, np.int64), np.zeros((0, 2), np.float32)
        return np.asarray(ids, np.int64), np.asarray(uvs, np.float32)


def histogram_equalize(img: np.ndarray, method: str = "HISTOGRAM") -> np.ndarray:
    """Image preprocessing (`TrackKLT.cpp:56-67`): NONE, HISTOGRAM
    (global equalization) or CLAHE."""
    import cv2

    if method == "NONE":
        return img
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    if method == "CLAHE":
        eq = cv2.createCLAHE(clipLimit=10.0, tileGridSize=(8, 8)).apply(u8)
    else:
        eq = cv2.equalizeHist(u8)
    return eq.astype(img.dtype) if img.dtype != np.uint8 else eq
