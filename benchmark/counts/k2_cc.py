"""The least traffic of K2, the 2D connected-component labelling, for
one call on a stacked [planes, H, W] uint8 mask: 1 byte read and a 4-byte
label written for each pixel. Labelling does no arithmetic worth a
bound, so bytes alone bound it."""

from __future__ import annotations


def bytes_moved(planes: int, h: int, w: int) -> int:
    return 5 * planes * h * w
