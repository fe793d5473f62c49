"""Least device time of the port's hand-written kernels, from their shapes.

Each input byte is read once and each output byte written once; the
operations are those the function needs, not those an implementation
runs.  A roofline share is this bound over the measured device time.
"""

from __future__ import annotations

from port_bench.counts import peaks


def decode_bytes(b: int, h: int, w: int, cell: int = 8) -> int:
    """Fused decode + threshold: ``(B, Hc, Wc, 65)`` float32 logits in,
    ``(B, H, W)`` float32 map out."""
    return 4 * b * (h // cell) * (w // cell) * 65 + 4 * b * h * w


def nms_bytes(b: int, h: int, w: int) -> int:
    """Grid NMS: the ``(B, H, W)`` float32 map in and the kept map out."""
    return 2 * 4 * b * h * w


def bytes_bound_s(nbytes: int) -> float:
    return nbytes / peaks.HBM_BYTES_PER_S


def desc_loss_bound_s(b: int, n: int, d: int, products: int) -> tuple:
    """The hinge descriptor loss over all N x N cell pairs: ``products``
    N x N x D products (2 forward, 4 backward) of ``2 B N^2 D`` FLOPs each
    against the TF32 peak, or four ``(B, N, D)`` float32 arrays of traffic,
    whichever is longer.  Returns ``(seconds, "ops" or "bytes")``."""
    ops = products * 2.0 * b * n * n * d / peaks.TF32_FLOPS
    traffic = 4 * 4.0 * b * n * d / peaks.HBM_BYTES_PER_S
    return (ops, "ops") if ops >= traffic else (traffic, "bytes")
