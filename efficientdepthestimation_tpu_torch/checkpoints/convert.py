"""The JAX package's variable tree as a PyTorch ``state_dict`` of the port,
and back.

Module paths are kept (``E/_blocks.0/_bn1`` → ``E._blocks.0._bn1``); leaves
are renamed and conv kernels transposed from HWIO to OIHW, which also turns
a depthwise ``(k, k, 1, C)`` kernel into PyTorch's ``(C, 1, k, k)``.
``to_jax_leaf`` inverts the map for one entry (key and value), so a port
tensor (a parameter, its gradient or a statistic) can be compared with the
JAX leaf it came from; ``to_jax_variables`` inverts it for a whole
``state_dict`` (or any dict keyed by parameter names, such as Adam's
moments), which is what the ``.ede`` writers store. ``pack_tree`` and
``unpack_tree`` write and read such a tree as flax's msgpack does (each
array an extension of type 1 holding msgpack ``(shape, dtype name, raw
C-order bytes)``, a numpy scalar type 3).

Some JAX module names hold dots: numbered submodules (``_blocks.3``,
``layer1.0``, ``norm.1``), DenseNet's old torchvision names
(``features.conv0``, ``features.denseblock1.denselayer1``,
``features.transition1.norm``) and SENet's ``layer0.conv1`` and
``se_module.fc1``. The port nests a container for each dot, so joining a
JAX path with '.' gives its key; ``_jax_modules`` joins the parts of a key
back into those names.
"""

from __future__ import annotations

import re

import msgpack
import numpy as np
import torch

__all__ = ["from_jax_variables", "to_jax_leaf", "to_jax_variables",
           "pack_tree", "unpack_tree"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: dict, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays → state_dict."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            *modules, name = path
            torch_name = _LEAF_NAMES.get((collection, name))
            if torch_name is None:
                raise ValueError(
                    f"unknown leaf {collection}/{'/'.join(path)}")
            arr = np.asarray(leaf)
            if name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            state[".".join([*modules, torch_name])] = torch.tensor(arr)
    return state


# A JAX module name that continues, after a dot, with the next part of a
# key: DenseNet's ``features.*`` and ``features.denseblockN.*`` /
# ``features.transitionN.*``, SENet's ``layer0.*`` and ``se_module.*``.
_DOTTED_HEAD = re.compile(
    r"features(\.(denseblock|transition)\d+)?|layer0|se_module")


def _jax_modules(torch_modules: list[str]) -> list[str]:
    """The JAX module names of a key's parts: a number joins the name
    before it (``["_blocks", "0"]`` → ``["_blocks.0"]``, ``norm.1``), and
    so does any part after a dotted head (``["layer0", "conv1"]`` →
    ``["layer0.conv1"]``)."""
    out = []
    for part in torch_modules:
        if out and (part.isdigit() or _DOTTED_HEAD.fullmatch(out[-1])):
            out[-1] = f"{out[-1]}.{part}"
        else:
            out.append(part)
    return out


def to_jax_leaf(key: str, value) -> tuple[str, str, np.ndarray]:
    """A port ``state_dict`` entry as ``(collection, "a/b/leaf", array)`` of
    the JAX variable tree, with conv kernels back in HWIO."""
    *modules, name = key.split(".")
    arr = np.asarray(value.detach().cpu().float() if isinstance(
        value, torch.Tensor) else value)
    leaf = {"running_mean": "mean", "running_var": "var",
            "bias": "bias"}.get(name)
    if name == "weight" and arr.ndim == 4:
        leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
    elif name == "weight" and arr.ndim == 1:
        leaf = "scale"
    if leaf is None:
        raise ValueError(f"no JAX leaf for {key} of shape {arr.shape}")
    collection = "batch_stats" if name.startswith("running_") else "params"
    return collection, "/".join([*_jax_modules(modules), leaf]), arr


def to_jax_variables(state: dict) -> dict:
    """A ``state_dict`` → ``{"params": ..., "batch_stats": ...}`` of numpy
    arrays under the JAX module paths, conv kernels in HWIO: the inverse of
    ``from_jax_variables``. The arrays are copies. A collection with no
    entry is left out."""
    tree: dict = {}
    for key, value in state.items():
        collection, path, arr = to_jax_leaf(key, value)
        *modules, leaf = path.split("/")
        node = tree.setdefault(collection, {})
        for name in modules:
            node = node.setdefault(name, {})
        node[leaf] = np.array(arr, order="C")
    return tree


def _ext_hook(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR else arr


def _ext_pack(obj):
    if isinstance(obj, np.generic):
        obj = np.asarray(obj)
    if not isinstance(obj, np.ndarray):
        raise TypeError(f"cannot store {type(obj).__name__} in a tree")
    payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")),
                            use_bin_type=True)
    return msgpack.ExtType(_EXT_NDARRAY, payload)


def pack_tree(tree: dict) -> bytes:
    """A nested dict of numpy arrays as flax's ``msgpack_serialize``
    writes it."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def unpack_tree(payload: bytes) -> dict:
    """The inverse of ``pack_tree`` (flax's ``msgpack_restore``)."""
    return msgpack.unpackb(payload, ext_hook=_ext_hook, raw=False)
