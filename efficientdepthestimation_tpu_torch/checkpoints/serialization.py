"""Reader for the JAX package's native ``.ede`` checkpoints, on msgpack alone.

Layout (``efficientdepthestimation_tpu/checkpoints/serialization.py``):
``b"EDE1"``, an 8-byte little-endian header length, a JSON header, then the
flax variable tree as msgpack in which each array is extension type 1
holding msgpack ``(shape, dtype name, raw C-order bytes)``.

Two model formats: ``hu2018-state`` (header ``encoder``, ``decoder``) and
the reference's self-describing MidasNet schema, ``midas-self-describing``
(``encoder.name``, ``decoder.num_features``/``non_negative``, and
``input_size``/``output_size`` in **WH** order, which the model takes as HW).
"""

from __future__ import annotations

import json
import warnings

import msgpack
import numpy as np
from torch import nn

from efficientdepthestimation_tpu_torch import MIDAS_CHECKPOINT_VERSION
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

__all__ = ["read_ede", "load_checkpoint", "load_midas", "check_midas_version",
           "midas_model", "MAGIC"]

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


def check_midas_version(header: dict) -> None:
    """Warn when a self-describing MidasNet's schema version is not the
    reference's (lasinger2019.py:396-400)."""
    if header.get("version") != MIDAS_CHECKPOINT_VERSION:
        warnings.warn(f"Version mismatch: checkpoint {header.get('version')} "
                      f"vs {MIDAS_CHECKPOINT_VERSION}.")


def midas_model(header: dict) -> nn.Module:
    """The MidasNet a self-describing header (an ``.ede`` header, or the
    reference's ``.pth`` dict) describes, sizes WH → HW."""
    w_in, h_in = header.get("input_size") or header["output_size"]
    w_out, h_out = header["output_size"]
    decoder = header["decoder"]
    return build_model(header["encoder"]["name"], "lasinger2019",
                       output_size=(h_out, w_out), input_size=(h_in, w_in),
                       num_features=decoder.get("num_features", "auto"),
                       non_negative=decoder.get("non_negative", False))


def load_checkpoint(path: str) -> tuple[nn.Module, dict]:
    """(model with the checkpoint's weights, on the CPU, eval; header)."""
    header, tree = read_ede(path)
    fmt = header.get("format")
    if fmt == "midas-self-describing":
        check_midas_version(header)
        model = midas_model(header)
    elif fmt == "hu2018-state":
        model = build_model(header["encoder"], header.get("decoder", "hu2018"))
    else:
        raise NotImplementedError(
            f".ede format {fmt!r} is not ported yet (ROADMAP A10)")
    model.load_state_dict(from_jax_variables(tree), strict=True)
    return model, header


def load_midas(path: str) -> tuple[nn.Module, dict]:
    """``load_checkpoint`` of a MidasNet checkpoint; ValueError otherwise."""
    model, header = load_checkpoint(path)
    if header.get("format") != "midas-self-describing":
        raise ValueError("Not a MidasNet checkpoint")
    return model, header
