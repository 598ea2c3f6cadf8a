"""Checkpoints of the four stages (counterpart of
``buffer_tpu/train/checkpoint.py``).

A checkpoint is the whole model's state dict under the reference's key
names (``Ref.encoder_blocks.0...``), written with ``torch.save``.  The
layout is the reference's snapshot scheme: ``{save_dir}/{stage}/best.pth``
and ``{save_dir}/{stage}/{epoch}.pth`` per stage (ThreeDMatch/trainer.py:
322-326), and a composition takes each stage from its own best file
(ThreeDMatch/test.py:207-214, :func:`merge_stage_checkpoints`).

The JAX trainer writes its variables as flax msgpack,
``{save_dir}/{stage}/best.msgpack``: :func:`load_file` and
:func:`save_variables` read and write that format with a decoder and an
encoder of their own for the subset flax emits (maps with string keys,
arrays, strings, bin, ext, ints, floats, nil, bools); an array is ext type 1
(a numpy scalar ext type 3) holding the packed ``(shape, dtype name,
C-order bytes)``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def save(model: torch.nn.Module, path: str) -> None:
    """The model's state dict, moved to the CPU, to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """A state dict written by :func:`save` (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def best_file(directory: str, stage: str) -> str:
    """``<directory>/<stage>/best.msgpack`` (the JAX trainer's) where that
    file exists, else ``<directory>/<stage>/best.pth``."""
    jax_file = os.path.join(directory, stage, "best.msgpack")
    if os.path.exists(jax_file):
        return jax_file
    return os.path.join(directory, stage, "best.pth")


def merge_stage_checkpoints(paths: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Per-stage checkpoint files {stage: path} -> one state dict in which
    every stage's entries come from its own file: a ``.msgpack`` file is
    the JAX trainer's variables (that stage's subtree, converted by
    ``compat.from_jax.variables_to_state_dict``), any other this
    package's state dict."""
    from buffer_tpu_torch.compat.from_jax import variables_to_state_dict
    merged = {}
    for stage, path in paths.items():
        if path.endswith(".msgpack"):
            sd = {k: torch.from_numpy(v) for k, v in variables_to_state_dict(
                {stage: load_file(path)[stage]}).items()}
        else:
            sd = load(path)
        merged.update({k: v for k, v in sd.items()
                       if k.startswith(stage + ".")})
    return merged


# ---- flax msgpack ---------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


# type byte -> (struct format of a length, kind) for the sized types
_SIZED = {0xc4: ("B", "bin"), 0xc5: ("H", "bin"), 0xc6: ("I", "bin"),
          0xc7: ("B", "ext"), 0xc8: ("H", "ext"), 0xc9: ("I", "ext"),
          0xd9: ("B", "str"), 0xda: ("H", "str"), 0xdb: ("I", "str"),
          0xdc: ("H", "array"), 0xdd: ("I", "array"),
          0xde: ("H", "map"), 0xdf: ("I", "map")}
_SCALARS = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q",
            0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _decode(_Reader(payload))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _decode(r: _Reader):
    b = r.num("B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif b in _SIZED:
        fmt, kind = _SIZED[b]
        n = r.num(fmt)
    elif b in _FIXEXT:
        kind, n = "ext", _FIXEXT[b]
    elif b in _SCALARS:
        return r.num(_SCALARS[b])
    elif b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b]
    else:
        raise ValueError(f"msgpack: type byte {b:#x} is not read")
    if kind == "map":
        return {_decode(r): _decode(r) for _ in range(n)}
    if kind == "array":
        return [_decode(r) for _ in range(n)]
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    code = r.num("b")
    payload = r.take(n)
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: ext type {code} is not read")


def load_file(path: str):
    """A flax msgpack file (the JAX trainer's ``save_variables``) as nested
    dicts of numpy arrays, as ``flax.serialization.msgpack_restore``
    gives them.  Raises on a type the format's flax subset does not use."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _sized(out: bytearray, n: int, small, codes) -> None:
    """The header of a sized type: a fix form for n < small (its base
    code), else the 8/16/32-bit form (codes, None where absent)."""
    if small and n < small[0]:
        out.append(small[1] | n)
        return
    for fmt, code in zip("BHI", codes):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"msgpack: {n} items or bytes is too many")


def _encode(x, out: bytearray) -> None:
    if x is None or isinstance(x, bool):
        out.append({None: 0xc0, False: 0xc2, True: 0xc3}[x])
    elif isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        code = _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY
        a = np.asarray(x)
        body = bytearray()
        _encode([list(a.shape), a.dtype.name, a.tobytes("C")], body)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(body) in fixed:
            out.append(fixed[len(body)])
        else:
            _sized(out, len(body), None, (0xc7, 0xc8, 0xc9))
        out += struct.pack(">b", code) + body
    elif isinstance(x, int):
        if 0 <= x <= 0x7f or -32 <= x < 0:
            out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            fmt, code = next((f, c) for f, c in zip("BHIQ", (0xcc, 0xcd, 0xce, 0xcf))
                             if x < 1 << (8 * struct.calcsize(f)))
            out += struct.pack(">B" + fmt, code, x)
        else:
            fmt, code = next((f, c) for f, c in zip("bhiq", (0xd0, 0xd1, 0xd2, 0xd3))
                             if x >= -(1 << (8 * struct.calcsize(f) - 1)))
            out += struct.pack(">B" + fmt, code, x)
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xcb, x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _sized(out, len(raw), (32, 0xa0), (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _sized(out, len(x), None, (0xc4, 0xc5, 0xc6))
        out += x
    elif isinstance(x, (list, tuple)):
        _sized(out, len(x), (16, 0x90), (None, 0xdc, 0xdd))
        for v in x:
            _encode(v, out)
    elif isinstance(x, dict):
        _sized(out, len(x), (16, 0x80), (None, 0xde, 0xdf))
        for k, v in x.items():
            _encode(str(k), out)
            _encode(v, out)
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def save_variables(variables: Dict[str, dict], path: str) -> None:
    """Nested dicts of arrays (numpy or tensors, e.g. the JAX package's
    variables ``{stage: {'params': ..., 'batch_stats': ...}}``) to ``path``
    in flax msgpack, as the JAX trainer's ``save_variables`` writes them
    (``flax.serialization.msgpack_restore`` reads the file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = bytearray()
    _encode(variables, out)
    with open(path, "wb") as f:
        f.write(bytes(out))
