"""Host-side image reading and resizing without OpenCV
(`feature_point_cnn_tpu/utils/image.py`, and the image reads of
`selflabel/coco.py:32-41` and `eval/hpatches.py:63-77`).

The H100 machine has neither ``cv2`` nor ``PIL``, so the formats the
self-labeling and evaluation paths read there are decoded with numpy:

* uncompressed 24-bit BMP (`read_bmp`);
* 8-bit binary PPM/PGM, ``P6``/``P5`` (`read_pnm`), HPatches' format.

Other files go through ``cv2`` where it is importable; where it is not,
`read_rgb` and `read_gray` raise an ``ImportError`` that names the file.  ``cv2`` is
imported inside the function, never when this module is imported.

Resizes follow OpenCV's arithmetic: `ratio_preserving_crop` is the
half-pixel-centre bilinear of ``INTER_LINEAR`` (OpenCV's fixed-point
weights on uint8 may differ by 1 LSB), and `resize_area` is ``INTER_AREA``
as weight matrices of fractional pixel overlaps (OpenCV's
``computeResizeAreaTab``; ``F.interpolate(mode="area")`` is exact only for
integer factors).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma in OpenCV's 14-bit fixed point (`cvtColor`, `imread` gray)
_GRAY_SHIFT = 14
_GRAY_R = 4899
_GRAY_G = 9617
_GRAY_B = (1 << _GRAY_SHIFT) - _GRAY_R - _GRAY_G


def read_bmp(path) -> np.ndarray:
    """An uncompressed 24-bit BMP -> ``(H, W, 3)`` uint8 RGB.  Raises
    ``ValueError`` for any other BMP variant (palette, 16/32-bit, RLE)."""
    data = Path(path).read_bytes()
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = int.from_bytes(data[10:14], "little")
    width = int.from_bytes(data[18:22], "little", signed=True)
    height = int.from_bytes(data[22:26], "little", signed=True)
    bpp = int.from_bytes(data[28:30], "little")
    compression = int.from_bytes(data[30:34], "little")
    if bpp != 24 or compression != 0 or width <= 0 or height == 0:
        raise ValueError(
            f"{path}: only uncompressed 24-bit BMP is read without cv2 "
            f"(found {bpp} bits, compression {compression})")
    rows = abs(height)
    stride = (width * 3 + 3) // 4 * 4
    if len(data) < offset + stride * rows:
        raise ValueError(f"{path}: truncated BMP pixel data")
    pix = np.frombuffer(data, np.uint8, stride * rows, offset)
    pix = pix.reshape(rows, stride)[:, :width * 3].reshape(rows, width, 3)
    if height > 0:                   # bottom-up rows
        pix = pix[::-1]
    return np.ascontiguousarray(pix[..., ::-1])   # BGR -> RGB


def _pnm_header(data: bytes, path) -> Tuple[bytes, int, int, int, int]:
    """``(magic, width, height, maxval, offset of the pixels)``."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":            # comment to the end of line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PNM header")
        fields.append(data[start:pos])
    magic = fields[0]
    try:
        width, height, maxval = (int(f) for f in fields[1:])
    except ValueError:
        raise ValueError(f"{path}: malformed PNM header") from None
    return magic, width, height, maxval, pos + 1  # one whitespace byte


def read_pnm(path) -> np.ndarray:
    """An 8-bit binary PPM (``P6``) or PGM (``P5``) -> ``(H, W, 3)`` RGB
    or ``(H, W)`` gray, uint8."""
    data = Path(path).read_bytes()
    magic, width, height, maxval, offset = _pnm_header(data, path)
    if magic not in (b"P5", b"P6") or not 0 < maxval < 256:
        raise ValueError(f"{path}: only 8-bit binary PPM/PGM (P6/P5) is "
                         f"read, found {magic!r} with maxval {maxval}")
    channels = 3 if magic == b"P6" else 1
    count = width * height * channels
    if len(data) < offset + count:
        raise ValueError(f"{path}: truncated PNM pixel data")
    pix = np.frombuffer(data, np.uint8, count, offset).reshape(height, width, channels)
    return pix[..., 0].copy() if channels == 1 else pix.copy()


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB -> ``(H, W)`` uint8 luma, bit for bit
    OpenCV's ``COLOR_RGB2GRAY`` (BT.601 weights in 14-bit fixed point)."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * _GRAY_R + c[..., 1] * _GRAY_G + c[..., 2] * _GRAY_B
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def _cv2_read(path, gray: bool):
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"{path}: decoding {Path(path).suffix} needs cv2, which is not "
            "installed; only 24-bit BMP and binary PPM/PGM are read without it"
        ) from None
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if img is None or gray:
        return img
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_rgb(path):
    """An image the self-labeling path reads -> ``(H, W, 3)`` uint8 RGB.
    24-bit BMP is decoded with numpy, other files through ``cv2``: ``None``
    where ``cv2`` cannot decode the file (as ``cv2.imread``), an
    ``ImportError`` naming the file where ``cv2`` is missing."""
    if Path(path).suffix.lower() == ".bmp" and _is_bmp24(path):
        return read_bmp(path)
    return _cv2_read(path, gray=False)


def read_gray(path) -> np.ndarray:
    """An image the evaluation path reads -> ``(H, W)`` uint8 gray, as
    ``cv2.imread(path, IMREAD_GRAYSCALE)``: PPM/PGM decoded with numpy,
    other files through ``cv2``; ``FileNotFoundError`` where it cannot be
    decoded."""
    if Path(path).suffix.lower() in (".ppm", ".pgm"):
        img = read_pnm(path)
        img = img if img.ndim == 2 else rgb_to_gray(img)
    else:
        img = _cv2_read(path, gray=True)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _is_bmp24(path) -> bool:
    with open(path, "rb") as f:
        head = f.read(34)
    return (len(head) == 34 and head[:2] == b"BM"
            and int.from_bytes(head[28:30], "little") == 24
            and int.from_bytes(head[30:34], "little") == 0)


def resize_bilinear(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``(H, W[, C])`` -> ``out_hw`` with half-pixel-centre bilinear
    (``cv2.INTER_LINEAR``); uint8 rounds back to uint8, floats keep their
    dtype."""
    x = torch.from_numpy(np.ascontiguousarray(image))
    gray = x.dim() == 2
    x = x[..., None] if gray else x
    dtype = x.dtype if x.is_floating_point() else torch.float32
    y = F.interpolate(x.permute(2, 0, 1)[None].to(dtype), size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=False)
    y = y[0].permute(1, 2, 0)
    if not x.is_floating_point():
        info = torch.iinfo(x.dtype)
        y = torch.round(y).clamp(info.min, info.max).to(x.dtype)
    out = y.numpy()
    return out[..., 0] if gray else out


def ratio_preserving_crop(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Ratio-preserving resize then centre crop to ``(H, W)``
    (`feature_point_cnn_tpu/utils/image.py:10-27`): the scale that covers
    ``out_hw``, the new size truncated to integers, a bilinear resize, the
    centre cut.  ``image``: ``(H, W, C)`` float or uint8; the same dtype
    comes back."""
    oh, ow = out_hw
    ih, iw = image.shape[:2]
    scale = max(oh / ih, ow / iw)
    nh, nw = int(ih * scale), int(iw * scale)
    resized = resize_bilinear(image, (nh, nw))
    y0 = (nh - oh) // 2
    x0 = (nw - ow) // 2
    return resized[y0:y0 + oh, x0:x0 + ow]


def _area_weights(src: int, dst: int, shrink: bool) -> np.ndarray:
    """``(dst, src)`` weights of ``cv2.INTER_AREA`` along one axis.

    ``shrink`` (both axes shrink): each output pixel averages the input
    pixels its cell covers, weighted by the covered fraction (OpenCV's
    ``computeResizeAreaTab``, float32 weights, slivers under 1e-3 dropped).
    Otherwise OpenCV's two-tap area interpolation, the edge pixel
    repeated."""
    w = np.zeros((dst, src), np.float64)
    scale = src / dst
    if shrink:
        for dx in range(dst):
            fsx1 = dx * scale
            fsx2 = fsx1 + scale
            cell = min(scale, src - fsx1)
            sx2 = min(int(np.floor(fsx2)), src - 1)
            sx1 = min(int(np.ceil(fsx1)), sx2)
            if sx1 - fsx1 > 1e-3:
                w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
            w[dx, sx1:sx2] = np.float32(1.0 / cell)
            if fsx2 - sx2 > 1e-3:
                w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
        return w
    inv = dst / src
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        w[dx, min(sx, src - 1)] += 1.0 - fx
        w[dx, min(sx + 1, src - 1)] += fx
    return w


def resize_area(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``(H, W)`` uint8 -> ``out_hw`` as ``cv2.resize(..., INTER_AREA)``
    (to 1 LSB: OpenCV sums in float32, and in fixed point where it grows)."""
    oh, ow = out_hw
    ih, iw = image.shape[:2]
    if (ih, iw) == (oh, ow):
        return image.copy()
    shrink = ih >= oh and iw >= ow   # OpenCV's area path needs both
    out = (_area_weights(ih, oh, shrink) @ image.astype(np.float64)
           @ _area_weights(iw, ow, shrink).T)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
