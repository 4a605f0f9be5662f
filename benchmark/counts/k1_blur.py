"""The least work of K1, the separable Gaussian blur of the heatmap
targets, for one call on [planes, H, W] float32: each input element read
once and each output element written once (8 bytes an element), and a
multiply and an add for each of the 2 * radius + 1 taps of each of the
two passes. The radius is scipy's, int(4 * sigma + 0.5)."""

from __future__ import annotations


def taps(sigma: float) -> int:
    return 2 * int(4.0 * float(sigma) + 0.5) + 1


def bytes_moved(planes: int, h: int, w: int) -> int:
    return 8 * planes * h * w


def flops(planes: int, h: int, w: int, sigma: float) -> int:
    return 2 * 2 * taps(sigma) * planes * h * w
