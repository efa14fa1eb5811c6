"""The JAX package's variable tree as a PyTorch ``state_dict`` of the port.

Module paths are kept (``E/_blocks.0/_bn1`` → ``E._blocks.0._bn1``); leaves
are renamed and conv kernels transposed from HWIO to OIHW, which also turns
a depthwise ``(k, k, 1, C)`` kernel into PyTorch's ``(C, 1, k, k)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_variables"]

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
