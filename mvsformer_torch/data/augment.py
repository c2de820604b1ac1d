"""Image normalisation for the eval dataset.

The part of `mvsformer_tpu/data/augment.py` that evaluation reads: the
ImageNet statistics and `normalize`. The training augmentation (the shared
colour jitter and gamma) comes with the training data layer (ROADMAP A4).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray) -> np.ndarray:
    """ImageNet normalisation of an RGB image in [0, 1], channels last."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD
