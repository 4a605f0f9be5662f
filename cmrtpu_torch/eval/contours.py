"""First-party external-contour extraction (Suzuki–Abe border following).

Replaces ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)`` for the
contour-walk insertion-point extraction (ref: src/data/Preprocess.py:36-37),
removing the OpenCV dependency from the eval path (SURVEY.md §2.3).

Compatibility contract (property-tested against OpenCV on random masks, see
tests/test_eval.py): for every 8-connected foreground component the traced
point sequence — start pixel, traversal direction, and per-pixel order — is
byte-identical to OpenCV's, and contours are returned in OpenCV's order
(reverse raster-discovery order), so ``find_external_contours(m)[0]`` picks
the same contour ``cv2.findContours(...)[0][0]`` did.

Points are (x, y) pairs like OpenCV; callers that want (y, x) swap at the end
exactly like the reference does. The port's own copy of
``cmrtpu/eval/contours.py``, held equal to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# 8-neighbourhood in counter-clockwise order (image coordinates, y down):
# E, NE, N, NW, W, SW, S, SE
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DIR = {(_DY[k], _DX[k]): k for k in range(8)}


def _trace_border(fg: np.ndarray, y0: int, x0: int) -> List[Tuple[int, int]]:
    """Follow the outer border of the component containing (y0, x0).

    ``fg`` is a zero-padded boolean image; (y0, x0) must be the component's
    raster-first pixel, so its west neighbour is guaranteed background —
    Suzuki & Abe's outer-border start condition.
    Returns the border as [(y, x), ...] in padded coordinates.
    """
    # initial probe: examine the neighbourhood clockwise starting from west
    first = None
    for t in range(8):
        k = (4 - t) % 8
        ny, nx = y0 + _DY[k], x0 + _DX[k]
        if fg[ny, nx]:
            first = (ny, nx)
            break
    if first is None:  # isolated pixel
        return [(y0, x0)]

    border = []
    prev = first          # i2 in Suzuki's notation
    cur = (y0, x0)        # i3
    while True:
        # resume the neighbourhood search counter-clockwise from just past
        # the direction of the previous border pixel
        back = _DIR[(prev[0] - cur[0], prev[1] - cur[1])]
        nxt = None
        for t in range(1, 9):
            k = (back + t) % 8
            ny, nx = cur[0] + _DY[k], cur[1] + _DX[k]
            if fg[ny, nx]:
                nxt = (ny, nx)
                break
        border.append(cur)
        # closure: back at the start pixel about to re-enter the first probe
        if nxt == (y0, x0) and cur == first:
            break
        prev, cur = cur, nxt
    return border


def find_external_contours(mask: np.ndarray) -> List[List[Tuple[int, int]]]:
    """All outer borders of ``mask``'s 8-connected components, as lists of
    (x, y) points, ordered like OpenCV (reverse raster-discovery order)."""
    import scipy.ndimage

    m = np.asarray(mask) != 0
    if not m.any():
        return []
    padded = np.zeros((m.shape[0] + 2, m.shape[1] + 2), bool)
    padded[1:-1, 1:-1] = m
    labels, n = scipy.ndimage.label(padded, structure=np.ones((3, 3), bool))

    contours = []
    for comp in range(1, n + 1):
        ys, xs = np.nonzero(labels == comp)
        k0 = np.lexsort((xs, ys))[0]  # raster-first pixel
        walk = _trace_border(labels == comp, int(ys[k0]), int(xs[k0]))
        contours.append([(x - 1, y - 1) for (y, x) in walk])
    contours.reverse()
    return contours
