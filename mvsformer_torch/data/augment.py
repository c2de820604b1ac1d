"""Image normalisation and the training augmentation (numpy).

Port of `mvsformer_tpu/data/augment.py`: the ImageNet statistics and
`normalize`, and the photometric augmentation that every view of a sample
shares (one `JitterParams` draw a sample): brightness, contrast, saturation
and hue in a drawn order, then a gamma. The blends are the JAX package's
float32 formulas; the hue shift goes through OpenCV's uint8 HSV, which the
port computes itself (`utils/image.rgb_to_hsv_u8`, `hsv_to_rgb_u8`), after
the same truncating `(img * 255).astype(np.uint8)`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mvsformer_torch.utils.image import hsv_to_rgb_u8, rgb_to_hsv_u8

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class JitterParams:
    """One augmentation draw, shared by every view of a sample."""

    order: np.ndarray  # permutation of [0..3]: brightness, contrast, saturation, hue
    brightness: float
    contrast: float
    saturation: float
    hue: float
    gamma: float

    @staticmethod
    def draw(rng: np.random.Generator, brightness=0.2, contrast=0.1,
             saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1):
        """Draw from `rng` in the JAX package's order: the permutation, then
        the four factors, then the gamma."""
        return JitterParams(
            order=rng.permutation(4),
            brightness=float(rng.uniform(max(0, 1 - brightness), 1 + brightness)),
            contrast=float(rng.uniform(max(0, 1 - contrast), 1 + contrast)),
            saturation=float(rng.uniform(max(0, 1 - saturation), 1 + saturation)),
            hue=float(rng.uniform(-hue, hue)),
            gamma=float(rng.uniform(min_gamma, max_gamma)),
        )


def _grayscale(img):
    # ITU-R 601-2 luma, the weights torchvision uses.
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _grayscale(img).mean()
    return np.clip(img * factor + mean * (1 - factor), 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _grayscale(img)[..., None]
    return np.clip(img * factor + gray * (1 - factor), 0.0, 1.0)


def adjust_hue(img, offset):
    """Shift hue by `offset` (in turns, [-0.5, 0.5]) in OpenCV's uint8 HSV."""
    hsv = rgb_to_hsv_u8((img * 255).astype(np.uint8))
    h = hsv[..., 0].astype(np.int32)
    hsv[..., 0] = ((h + int(round(offset * 180))) % 180).astype(np.uint8)
    return hsv_to_rgb_u8(hsv).astype(np.float32) / 255.0


def apply_jitter(img: np.ndarray, p: JitterParams) -> np.ndarray:
    """img: [H, W, 3] float32 in [0, 1]. The jitter in the drawn order, then
    the gamma (clipped)."""
    for fn_id in p.order:
        if fn_id == 0:
            img = adjust_brightness(img, p.brightness)
        elif fn_id == 1:
            img = adjust_contrast(img, p.contrast)
        elif fn_id == 2:
            img = adjust_saturation(img, p.saturation)
        else:
            img = adjust_hue(img, p.hue)
    return np.clip(np.power(img, p.gamma), 0.0, 1.0)


def normalize(img: np.ndarray) -> np.ndarray:
    """ImageNet normalisation of an RGB image in [0, 1], channels last."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD
