"""Correspondence packing: the [N, 4] interchange format.

Correspondences travel as an [N, 4] int64 array of (orig_x, orig_y,
trans_x, trans_y) rows at image resolution, as in the JAX package's
`utils/correspondences.py` (reference: diffhandles/utils.py:111-117).
"""

from __future__ import annotations

import numpy as np


def pack_correspondences(original_x, original_y, transformed_x,
                         transformed_y) -> np.ndarray:
    return np.stack(
        [np.asarray(original_x), np.asarray(original_y),
         np.asarray(transformed_x), np.asarray(transformed_y)],
        axis=-1).astype(np.int64)


def unpack_correspondences(correspondences):
    correspondences = np.asarray(correspondences)
    if correspondences.size == 0:
        e = np.zeros((0,), dtype=np.int64)
        return e, e.copy(), e.copy(), e.copy()
    return (correspondences[..., 0], correspondences[..., 1],
            correspondences[..., 2], correspondences[..., 3])
