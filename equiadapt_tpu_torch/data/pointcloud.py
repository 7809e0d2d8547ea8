"""Point-cloud dataset loaders: ModelNet40 and ShapeNet-Part HDF5.

Counterpart of `equiadapt_tpu/data/pointcloud.py`, with the same numpy
bodies: the loaders read local HDF5 files under `data_path` and raise a
clear error when there are none (nothing is downloaded; `data.synthetic`
is the fallback). `h5py` is imported inside the reader, so importing this
module needs no h5py.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

__all__ = ["load_modelnet40", "load_shapenet_part", "normalize_pointcloud"]


def normalize_pointcloud(points: np.ndarray) -> np.ndarray:
    """Center and scale each cloud to the unit sphere (the reference's
    pc_normalize)."""
    centered = points - points.mean(axis=-2, keepdims=True)
    scale = np.sqrt((centered**2).sum(-1)).max(axis=-1, keepdims=True)
    return centered / scale[..., None]


def _load_h5_split(pattern: str, keys=("data", "label")) -> Dict[str, np.ndarray]:
    import h5py

    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(
            f"no HDF5 files matching {pattern}; this environment cannot "
            "download datasets — place them locally or use synthetic data"
        )
    out = {k: [] for k in keys}
    for f in files:
        with h5py.File(f, "r") as h:
            for k in keys:
                out[k].append(h[k][:])
    return {k: np.concatenate(v) for k, v in out.items()}


def load_modelnet40(
    data_path: str, num_points: int = 1024
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """modelnet40_ply_hdf5_2048 train/test splits -> points (N, P, 3) +
    labels."""
    root = os.path.join(data_path, "modelnet40_ply_hdf5_2048")
    train = _load_h5_split(os.path.join(root, "ply_data_train*.h5"))
    test = _load_h5_split(os.path.join(root, "ply_data_test*.h5"))

    def _prep(d):
        return {
            "points": d["data"][:, :num_points].astype(np.float32),
            "label": d["label"].reshape(-1).astype(np.int32),
        }

    return _prep(train), _prep(test)


def load_shapenet_part(
    data_path: str, split: str = "train", num_points: int = 2048
) -> Dict[str, np.ndarray]:
    """ShapeNet-Part HDF5 (hdf5_data/ply_data_{split}*.h5) with per-point
    part labels and object categories."""
    root = os.path.join(data_path, "shapenet_part_seg_hdf5_data")
    d = _load_h5_split(
        os.path.join(root, f"ply_data_{split}*.h5"), keys=("data", "label", "pid")
    )
    return {
        "points": d["data"][:, :num_points].astype(np.float32),
        "category": d["label"].reshape(-1).astype(np.int32),
        "part_label": d["pid"][:, :num_points].astype(np.int32),
    }
