"""JET colormap (port of ``ops/colormap.py``): the piecewise-linear ramp of
``cv2.applyColorMap(..., cv2.COLORMAP_JET)``, BGR uint8 like OpenCV."""

from __future__ import annotations

import numpy as np


def _jet_channel(v: np.ndarray, center: float) -> np.ndarray:
    """Triangular bump of half-width 0.25 around ``center / 4``."""
    return np.clip(1.5 - np.abs(4.0 * v - center), 0.0, 1.0)


def apply_jet(gray_u8: np.ndarray) -> np.ndarray:
    """uint8[H, W] -> uint8[H, W, 3] BGR jet colormap."""
    v = np.asarray(gray_u8).astype(np.float32) / 255.0
    bgr = np.stack([_jet_channel(v, 1.0), _jet_channel(v, 2.0), _jet_channel(v, 3.0)], axis=-1)
    return (bgr * 255.0).astype(np.uint8)
