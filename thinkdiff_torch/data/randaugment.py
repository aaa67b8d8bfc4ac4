"""RandAugment on the host, numpy uint8 HWC (the port's copy of
thinkdiff_tpu/data/randaugment.py; reference
thinkdiff/processors/randaugment.py:1-398, unused by the reference's active
configs).

The published operation set (Cubuk et al., arXiv 1909.13719) with the
reference's public surface: 14 ops, and ``RandomAugment(N, M, isPIL,
augs)`` applying N sampled ops, each with probability 0.5, at magnitude M
(MAX_LEVEL 10). Photometric ops are numpy lookup tables with
PIL.ImageOps / PIL.ImageEnhance semantics; geometric ops use PIL's affine
engine. The draws come from ``np.random`` (or the ``rng`` given) in the
JAX module's order, so one seed gives the same images in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MAX_LEVEL = 10
TRANSLATE_CONST = 10
REPLACE_VALUE = (128, 128, 128)


def _pil_luma(img: np.ndarray) -> np.ndarray:
    """PIL convert('L') exactly: (r*19595 + g*38470 + b*7471 + 0x8000) >> 16."""
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


# ---- photometric ops (numpy LUTs, PIL semantics) --------------------------

def identity(img: np.ndarray) -> np.ndarray:
    return img


def autocontrast(img: np.ndarray, cutoff: int = 0) -> np.ndarray:
    """Per-channel linear stretch to full range (PIL.ImageOps.autocontrast)."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
            continue
        scale = 255.0 / (hi - lo)
        table = np.clip((np.arange(256) - lo) * scale, 0, 255).astype(np.uint8)
        out[..., c] = table[ch]
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """Histogram equalization with PIL.ImageOps.equalize's step rule."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        hist = np.bincount(ch.reshape(-1), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (int(hist.sum()) - int(nonzero[-1])) // 255
        if step == 0:
            out[..., c] = ch
            continue
        # PIL: lut[i] = (cumsum(hist)[:i] + step // 2) // step
        cum = np.concatenate([[0], np.cumsum(hist)[:-1]])
        table = np.clip((cum + step // 2) // step, 0, 255).astype(np.uint8)
        out[..., c] = table[ch]
    return out


def solarize(img: np.ndarray, thresh: int = 128) -> np.ndarray:
    lut = np.arange(256)
    lut = np.where(lut < thresh, lut, 255 - lut).astype(np.uint8)
    return lut[img]


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep the top ``bits`` bits per channel (bits 0 blacks out)."""
    mask = np.uint8((255 << (8 - bits)) & 255) if bits > 0 else np.uint8(0)
    return np.bitwise_and(img, mask)


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    out = degenerate.astype(np.float32) + factor * (
        img.astype(np.float32) - degenerate.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """Saturation blend toward the luma grayscale (PIL.ImageEnhance.Color)."""
    gray = _pil_luma(img)
    return _blend(gray[..., None].repeat(img.shape[2], -1), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = int(_pil_luma(img).astype(np.float64).mean() + 0.5)
    degenerate = np.full_like(img, np.uint8(np.clip(mean, 0, 255)))
    return _blend(degenerate, img, factor)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(np.zeros_like(img), img, factor)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend toward a 3x3 smoothing (PIL's SMOOTH kernel: [[1,1,1],
    [1,5,1],[1,1,1]]/13); PIL leaves the 1-pixel border unchanged."""
    f = img.astype(np.float32)
    pad = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    acc = np.zeros_like(f)
    weights = {(0, 0): 5.0}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = weights.get((dy, dx), 1.0)
            acc += w * pad[1 + dy:pad.shape[0] - 1 + dy,
                           1 + dx:pad.shape[1] - 1 + dx]
    # PIL's C filter rounds half-up: (float)sum / divisor + 0.5, truncated
    smooth = np.clip(np.floor(acc / 13.0 + 0.5), 0, 255)
    degenerate = f.copy()
    degenerate[1:-1, 1:-1] = smooth[1:-1, 1:-1]
    return _blend(degenerate.astype(np.uint8), img, factor)


# ---- geometric ops (PIL affine engine) ------------------------------------

def _affine(img: np.ndarray, coeffs: Sequence[float],
            fill: Tuple[int, int, int]) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(img)
    out = pil.transform(pil.size, Image.AFFINE, tuple(coeffs),
                        resample=Image.NEAREST, fillcolor=tuple(fill))
    return np.asarray(out)


def rotate(img: np.ndarray, degree: float,
           fill: Tuple[int, int, int] = (0, 0, 0)) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(img)
    out = pil.rotate(degree, resample=Image.NEAREST, fillcolor=tuple(fill))
    return np.asarray(out)


def shear_x(img, factor, fill=(0, 0, 0)):
    return _affine(img, (1, factor, 0, 0, 1, 0), fill)


def shear_y(img, factor, fill=(0, 0, 0)):
    return _affine(img, (1, 0, 0, factor, 1, 0), fill)


def translate_x(img, offset, fill=(0, 0, 0)):
    # output(x, y) = input(x + offset, y): positive offset shifts LEFT,
    # mirroring the reference's warpAffine sign convention
    return _affine(img, (1, 0, offset, 0, 1, 0), fill)


def translate_y(img, offset, fill=(0, 0, 0)):
    return _affine(img, (1, 0, 0, 0, 1, offset), fill)


def cutout(img: np.ndarray, pad_size: int,
           replace: Tuple[int, int, int] = (0, 0, 0),
           rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = img.shape[:2]
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    y0, y1 = max(0, cy - pad_size), min(h, cy + pad_size)
    x0, x1 = max(0, cx - pad_size), min(w, cx + pad_size)
    out = img.copy()
    out[y0:y1, x0:x1] = np.asarray(replace, np.uint8)
    return out


# ---- level -> op-args mappings (reference magnitudes) ---------------------

def _enhance_args(level, rng):
    return ((level / MAX_LEVEL) * 1.8 + 0.1,)


def _shear_args(level, rng):
    mag = (level / MAX_LEVEL) * 0.3
    return (-mag if rng.random() > 0.5 else mag, REPLACE_VALUE)


def _translate_args(level, rng):
    mag = (level / MAX_LEVEL) * float(TRANSLATE_CONST)
    return (-mag if rng.random() > 0.5 else mag, REPLACE_VALUE)


def _rotate_args(level, rng):
    mag = (level / MAX_LEVEL) * 30.0
    return (-mag if rng.random() < 0.5 else mag, REPLACE_VALUE)


def _solarize_args(level, rng):
    return (int((level / MAX_LEVEL) * 256),)


def _posterize_args(level, rng):
    return (int((level / MAX_LEVEL) * 4),)


def _no_args(level, rng):
    return ()


OPS = {
    "Identity": (identity, _no_args),
    "AutoContrast": (autocontrast, _no_args),
    "Equalize": (equalize, _no_args),
    "Rotate": (rotate, _rotate_args),
    "Solarize": (solarize, _solarize_args),
    "Color": (color, _enhance_args),
    "Contrast": (contrast, _enhance_args),
    "Brightness": (brightness, _enhance_args),
    "Sharpness": (sharpness, _enhance_args),
    "ShearX": (shear_x, _shear_args),
    "TranslateX": (translate_x, _translate_args),
    "TranslateY": (translate_y, _translate_args),
    "Posterize": (posterize, _posterize_args),
    "ShearY": (shear_y, _shear_args),
}


class RandomAugment:
    """Apply ``N`` randomly-chosen ops (each with probability 0.5) at
    magnitude ``M`` — the reference's public surface
    (randaugment.py:326-347). numpy uint8 HWC in/out; ``isPIL`` converts a
    PIL input first."""

    def __init__(self, N: int = 2, M: int = 10, isPIL: bool = False,
                 augs: Optional[List[str]] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.N = N
        self.M = M
        self.isPIL = isPIL
        self.augs = list(augs) if augs else list(OPS.keys())
        unknown = set(self.augs) - set(OPS)
        if unknown:
            raise KeyError(f"Unknown augmentation ops: {sorted(unknown)}")
        self.rng = rng or np.random

    def get_random_ops(self):
        sampled = self.rng.choice(self.augs, self.N)
        return [(op, 0.5, self.M) for op in sampled]

    def __call__(self, img):
        if self.isPIL:
            img = np.asarray(img)
        img = np.asarray(img, np.uint8)
        for name, prob, level in self.get_random_ops():
            if self.rng.random() > prob:
                continue
            fn, to_args = OPS[name]
            img = fn(img, *to_args(level, self.rng))
        return img
