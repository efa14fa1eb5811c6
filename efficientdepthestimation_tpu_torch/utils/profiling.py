"""Device memory accounting of one call.

Counterpart of ``peak_memory`` in
``efficientdepthestimation_tpu/utils/profiling.py:75-87``. The JAX package
reads the live allocator's peak where the backend reports one, else the
compiled executable's static reservation, and labels which. The port does
the same with what PyTorch offers on each device.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["peak_memory"]


class _CreatedBytes(TorchDispatchMode):
    """Adds up the storage bytes of every tensor the operators create."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr() for t in tree_leaves(
            (args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and not t._is_view()
                    and t.untyped_storage().data_ptr() not in inputs):
                self.total += t.untyped_storage().nbytes()
        return out


def _nbytes(args) -> int:
    return sum(t.untyped_storage().nbytes() for t in tree_leaves(args)
               if isinstance(t, torch.Tensor))


def peak_memory(fn, example_args=(), device=None) -> tuple[int, str]:
    """``(bytes, source)`` of one call ``fn(*example_args)`` on ``device``
    (by default the device of the first tensor argument).

    - On a CUDA card, ``"live"``: the caching allocator's peak during the
      call (``torch.cuda.max_memory_allocated`` after
      ``reset_peak_memory_stats``), everything the card held at once, the
      weights included.
    - On the CPU, where PyTorch keeps no allocator statistics,
      ``"static"``, as the JAX package labels the figure it reads from the
      compiled program on such a backend (arguments, temporaries and
      outputs): the bytes of the arguments plus those of every tensor the
      call's operators create, counted from their shapes as they are made
      and none counted as freed, so at least the call's peak. Weights
      already held by ``fn`` are not counted.
    """
    if device is None:
        tensors = [t for t in tree_leaves(example_args)
                   if isinstance(t, torch.Tensor)]
        device = tensors[0].device if tensors else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn(*example_args)
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device)), "live"
    with _CreatedBytes() as tally:
        fn(*example_args)
    return _nbytes(example_args) + tally.total, "static"
