"""Reader for the JAX package's native ``.ede`` checkpoints, on msgpack alone.

Layout (``efficientdepthestimation_tpu/checkpoints/serialization.py``):
``b"EDE1"``, an 8-byte little-endian header length, a JSON header, then the
flax variable tree as msgpack in which each array is extension type 1
holding msgpack ``(shape, dtype name, raw C-order bytes)``.
"""

from __future__ import annotations

import json

import msgpack
import numpy as np
from torch import nn

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

__all__ = ["read_ede", "load_checkpoint", "MAGIC"]

MAGIC = b"EDE1"
_EXT_NDARRAY = 1


def _ext_hook(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f".ede: unsupported msgpack extension type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_ede(path: str) -> tuple[dict, dict]:
    """(header, variable tree of numpy arrays) of an ``.ede`` file."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"Not an EDE checkpoint (magic {magic!r})")
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return header, tree


def load_checkpoint(path: str) -> tuple[nn.Module, dict]:
    """(model with the checkpoint's weights, on the CPU, eval; header)."""
    header, tree = read_ede(path)
    if header.get("format") != "hu2018-state":
        raise NotImplementedError(
            f".ede format {header.get('format')!r} is not ported yet "
            "(ROADMAP A7)")
    model = build_model(header["encoder"], header.get("decoder", "hu2018"))
    model.load_state_dict(from_jax_variables(tree), strict=True)
    return model, header
