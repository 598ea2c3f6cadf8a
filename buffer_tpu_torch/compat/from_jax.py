"""JAX variables <-> this package's state dict.

:func:`variables_to_state_dict` turns the JAX package's variables
``{'Ref', 'Desc', 'Keypt', 'Inlier'} -> {'params', 'batch_stats'}`` (as
numpy arrays) into a state dict under the reference's key names, which
:class:`~buffer_tpu_torch.models.composite.BufferModel` loads directly.
It is the inverse of the JAX package's ``compat/torch_convert.py``
``convert_state_dict``: Dense kernels (in, out) become Linear / 1x1-conv
weights (out, in, ...), conv kernels (k..., in, out) become (out, in, k...),
batch-norm ``mean``/``var`` become ``running_mean``/``running_var``.
:func:`state_dict_to_variables` is ``convert_state_dict`` itself, and
:func:`load_jax_model` builds a model from the JAX trainer's msgpack
checkpoints.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

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


def _vn_path(rest: list) -> Tuple[tuple, str]:
    """Torch key parts inside a VNLinearLeakyReLU -> (JAX path, kind)."""
    if rest[0] in ("map_to_feat", "map_to_dir"):
        return (rest[0], "kernel"), "linear"
    assert rest[:2] == ["batchnorm", "bn"], rest
    return ("batchnorm", "bn", rest[2]), ""


def _jax_path(stage: str, rest: list) -> Tuple[tuple, str]:
    """Torch key parts of one stage (after the stage name) -> (JAX path
    with the torch leaf name last, kernel kind): the inverse of
    :func:`_torch_key`."""
    if stage in ("Ref", "Keypt"):
        if rest[0] in ("encoder_blocks", "decoder_blocks"):
            path, kind = _vn_path(rest[3:])
            return (f"{rest[0]}_{rest[1]}", rest[2]) + path, kind
        if rest[0] == "fc_layer":
            path, kind = _vn_path(rest[2:])
            return (f"fc_layer_{rest[1]}",) + path, kind
        head = rest[0]
        if rest[1] == "0":
            if rest[2] == "vn_lin":
                return (head, "std", "vn_lin", "kernel"), "linear"
            path, kind = _vn_path(rest[3:])
            return (head, "std", rest[2]) + path, kind
        conv = {v: k for k, v in _HEAD.items()}[rest[1]]
        if rest[2] == "weight":
            return (head, conv, "kernel"), "conv1d"
        return (head, conv, "bias"), ""
    if stage == "Desc" and rest[0] == "conv_net":
        base, kind = ("conv_net", {v: k for k, v in _CYL.items()}[int(rest[2])]), "conv"
    elif stage == "Desc":
        base = ({v: k for k, v in _DESC.items()}[".".join(rest[:2])],)
        kind = "conv1x1"
    else:
        assert stage == "Inlier" and rest[:2] == ["conv", "ops"], rest
        base, kind = ("conv", {v: k for k, v in _COST.items()}[int(rest[2])]), "conv"
    if rest[-1] == "weight" and "bn" not in base[-1]:
        return base + ("kernel",), kind
    return base + (rest[-1],), ""


def _from_kernel(w: np.ndarray, kind: str) -> np.ndarray:
    """A torch weight in the layout of the flax kernel ``kind``: the
    inverse of :func:`_kernel`."""
    if kind == "linear":
        return w.T
    if kind == "conv1d":
        return w[:, :, 0].T
    if kind == "conv1x1":
        return w[:, :, 0, 0].T
    return w.transpose(tuple(range(2, w.ndim)) + (1, 0))


def state_dict_to_variables(sd: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """A state dict under the reference's key names (numpy arrays or CPU
    tensors) -> the JAX package's variables ``{stage: {'params': ...,
    'batch_stats': ...}}`` of numpy float32 arrays, as the JAX package's
    ``compat/torch_convert.py`` ``convert_state_dict`` makes them; the
    batch-norm counters and the unused ``epsilon`` are dropped."""
    leaf = {v: k for k, v in _LEAF.items()}
    out: Dict[str, dict] = {}
    for key, w in sd.items():
        stage, *rest = key.split(".")
        if rest == ["epsilon"] or rest[-1] == "num_batches_tracked":
            continue
        path, kind = _jax_path(stage, rest)
        w = np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w,
                       np.float32)
        coll = ("batch_stats" if path[-1] in ("running_mean", "running_var")
                else "params")
        path = path[:-1] + (leaf.get(path[-1], path[-1]),)
        node = out.setdefault(stage, {}).setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_from_kernel(w, kind) if kind
                                              else w)
    return out


def load_jax_model(cfg, paths: Dict[str, str], device=None):
    """A :class:`~buffer_tpu_torch.models.composite.BufferModel` of ``cfg``
    from the JAX trainer's flax-msgpack checkpoints, ``paths``: stage ->
    file (``<stage>/best.msgpack``), each stage's subtree from its own
    file (``buffer_tpu/train/checkpoint.py:37-45``), on ``device``
    (default: the CUDA card), in eval mode.  Raises when the files miss a
    parameter or buffer of the model or hold one it does not have."""
    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.train.checkpoint import load_file
    sd = variables_to_state_dict({stage: load_file(path)[stage]
                                  for stage, path in paths.items()})
    model = BufferModel(cfg)
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    unexpected = sorted(k for k in sd if k not in own)
    if missing or unexpected:
        raise KeyError(f"JAX checkpoints do not match the model: missing "
                       f"{missing[:8]} ({len(missing)} in all), unexpected "
                       f"{unexpected[:8]} ({len(unexpected)} in all)")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.to(resolve_device(device))
