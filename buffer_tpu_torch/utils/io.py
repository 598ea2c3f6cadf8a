"""Raw binary keypoint and descriptor files (counterpart of
``buffer_tpu/utils/io.py``; the reference's ``utils/tools.py:10-42``).

Keypoints are int64 indices or float32 xyz, descriptors float32 [N, dim]
with ``dim`` given by the reader.  ``loadlog`` is
:func:`buffer_tpu_torch.eval.metrics.load_log`.
"""

from __future__ import annotations

import numpy as np


def get_keypts(keypts_path: str) -> np.ndarray:
    """float32 xyz keypoints [N, 3] (utils/tools.py:17-21)."""
    return np.fromfile(keypts_path, dtype=np.float32).reshape(-1, 3)


def get_keypts_indices(keypts_path: str) -> np.ndarray:
    """int64 keypoint indices (utils/tools.py:10-14)."""
    return np.fromfile(keypts_path, dtype=np.int64)


def get_desc(desc_path: str, dim: int = 32) -> np.ndarray:
    """float32 descriptors [N, dim] (utils/tools.py:24-28)."""
    return np.fromfile(desc_path, dtype=np.float32).reshape(-1, dim)


def save_keypts(path: str, keypts: np.ndarray) -> None:
    """float32 xyz keypoints, raw."""
    np.asarray(keypts, np.float32).tofile(path)


def save_desc(path: str, desc: np.ndarray) -> None:
    """float32 descriptors, raw."""
    np.asarray(desc, np.float32).tofile(path)
