"""JAX variables -> this package's state dict.

:func:`variables_to_state_dict` turns the JAX package's variables
``{'Ref', 'Desc', 'Keypt', 'Inlier'} -> {'params', 'batch_stats'}`` (as
numpy arrays) into a state dict under the reference's key names, which
:class:`~buffer_tpu_torch.models.composite.BufferModel` loads directly.
It is the inverse of the JAX package's ``compat/torch_convert.py``
``convert_state_dict``: Dense kernels (in, out) become Linear / 1x1-conv
weights (out, in, ...), conv kernels (k..., in, out) become (out, in, k...),
batch-norm ``mean``/``var`` become ``running_mean``/``running_var``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np

# cylindrical-net / cost-net layer name -> index in the reference's ops list
_CYL = {"conv3d_0": 0, "bn3d_0": 1, "conv2d_out": 21}
_CYL.update({f"conv2d_{i}": 3 + 3 * i for i in range(6)})
_CYL.update({f"bn2d_{i}": 4 + 3 * i for i in range(6)})
_COST = {"conv3d_out": 27}
_COST.update({f"conv3d_{i}": 3 * i for i in range(9)})
_COST.update({f"bn3d_{i}": 3 * i + 1 for i in range(9)})
_HEAD = {"conv1": "1", "conv2": "3", "conv3": "5"}
_DESC = {"pnt_conv": "pnt_layer.0", "pnt_bn": "pnt_layer.1",
         "pool_conv1": "pool_layer.0", "pool_bn1": "pool_layer.1",
         "pool_conv2": "pool_layer.3", "pool_bn2": "pool_layer.4"}
_LEAF = {"weight": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _kernel(w: np.ndarray, kind: str) -> np.ndarray:
    """A flax kernel in the layout of the torch module ``kind``."""
    if kind == "linear":
        return w.T
    if kind == "conv1d":
        return w.T[:, :, None]
    if kind == "conv1x1":
        return w.T[:, :, None, None]
    perm = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
    return w.transpose(perm)                     # (k..., in, out) -> (out, in, k...)


def _vn_key(path: tuple) -> Tuple[str, str]:
    """Path inside a VNLinearLeakyReLU -> (torch suffix, kernel kind)."""
    if path[0] in ("map_to_feat", "map_to_dir"):
        return f"{path[0]}.weight", "linear"
    assert path[:2] == ("batchnorm", "bn"), path
    return f"batchnorm.bn.{_LEAF[path[2]]}", ""


def _torch_key(stage: str, path: tuple) -> Tuple[str, str]:
    """JAX variable path of one stage -> (torch key, kernel kind)."""
    if stage in ("Ref", "Keypt"):
        m = re.fullmatch(r"(encoder_blocks|decoder_blocks)_(\d+)", path[0])
        if m:
            suffix, kind = _vn_key(path[2:])
            return f"{m.group(1)}.{m.group(2)}.{path[1]}.{suffix}", kind
        m = re.fullmatch(r"fc_layer_(\d+)", path[0])
        if m:
            suffix, kind = _vn_key(path[1:])
            return f"fc_layer.{m.group(1)}.{suffix}", kind
        head = path[0]
        assert head in ("inv_layer", "invar_layer"), path
        if path[1] == "std":
            if path[2] == "vn_lin":
                return f"{head}.0.vn_lin.weight", "linear"
            suffix, kind = _vn_key(path[3:])
            return f"{head}.0.{path[2]}.{suffix}", kind
        if path[2] == "kernel":
            return f"{head}.{_HEAD[path[1]]}.weight", "conv1d"
        return f"{head}.{_HEAD[path[1]]}.bias", ""
    if stage == "Desc":
        if path[0] == "conv_net":
            base, kind = f"conv_net.ops.{_CYL[path[1]]}", "conv"
            leaf = path[2]
        else:
            base, kind = _DESC[path[0]], "conv1x1"
            leaf = path[1]
    else:
        assert stage == "Inlier" and path[0] == "conv", path
        base, kind, leaf = f"conv.ops.{_COST[path[1]]}", "conv", path[2]
    if leaf == "kernel":
        return f"{base}.weight", kind
    return f"{base}.{_LEAF[leaf]}", ""


def variables_to_state_dict(variables: Dict[str, dict]) -> Dict[str, np.ndarray]:
    """JAX variables (numpy leaves) -> state dict with the reference's keys,
    including each batch norm's ``num_batches_tracked`` (0) and the unused
    ``epsilon`` parameters of Ref and Keypt (-5, their reference value)."""
    sd: Dict[str, np.ndarray] = {}
    for stage, coll in variables.items():
        for tree in (coll.get("params", {}), coll.get("batch_stats", {})):
            for path, w in _leaves(tree):
                key, kind = _torch_key(stage, path)
                w = _kernel(w, kind) if kind else w
                sd[f"{stage}.{key}"] = np.ascontiguousarray(w, np.float32)
                if key.endswith("running_mean"):
                    nbt = key[: -len("running_mean")] + "num_batches_tracked"
                    sd[f"{stage}.{nbt}"] = np.array(0, np.int64)
        if stage in ("Ref", "Keypt"):
            sd[f"{stage}.epsilon"] = np.array(-5.0, np.float32)
    return sd
