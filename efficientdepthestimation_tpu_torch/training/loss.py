"""The 4-term depth training loss (depth + ∇x + ∇y + surface normal).

Counterpart of ``efficientdepthestimation_tpu/training/loss.py``, with the
semantics of the reference's inline loss (ReSIDE/train.py:216-236):

    L = mean(log(|ô−d|+0.5))
      + mean(|1 − cos(n̂, n)|)          n = (−∇x, −∇y, 1), cosine eps = 0
      + mean(log(|∇x̂−∇x|+0.5)) + mean(log(|∇ŷ−∇y|+0.5))

with ∇ the fixed Sobel stencil (zero padding 1). This is the plain PyTorch
form; the training step computes the same function through the kernel pair
of ``ops/kernels/fused_loss.py``.
"""

from __future__ import annotations

import torch

from efficientdepthestimation_tpu_torch.ops.sobel import sobel_gradients

__all__ = ["sample_mask", "depth_loss_maps", "depth_loss_terms", "depth_loss"]


def sample_mask(n: int, num_valid, device) -> torch.Tensor:
    """f32 (n,) weights: 1 for the first ``num_valid`` samples, else 0.
    ``num_valid`` may be None (all valid), an int or a 0-d tensor."""
    if num_valid is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    if isinstance(num_valid, torch.Tensor):
        num_valid = num_valid.to(device)
    return (torch.arange(n, device=device) < num_valid).float()


def depth_loss_maps(output: torch.Tensor, depth: torch.Tensor
                    ) -> tuple[torch.Tensor, ...]:
    """The four per-pixel terms (depth, dx, dy, normal), f32, of NHWC
    single-channel ``output``/``depth``."""
    output = output.float()
    depth = depth.float()
    gx_o, gy_o = sobel_gradients(output)
    gx_d, gy_d = sobel_gradients(depth)

    term_depth = torch.log(torch.abs(output - depth) + 0.5)
    term_dx = torch.log(torch.abs(gx_o - gx_d) + 0.5)
    term_dy = torch.log(torch.abs(gy_o - gy_d) + 0.5)

    # normals (−gx, −gy, 1); cosine similarity with eps=0
    dot = gx_o * gx_d + gy_o * gy_d + 1.0
    norm_o = torch.sqrt(gx_o.square() + gy_o.square() + 1.0)
    norm_d = torch.sqrt(gx_d.square() + gy_d.square() + 1.0)
    term_normal = torch.abs(1.0 - dot / (norm_o * norm_d))
    return term_depth, term_dx, term_dy, term_normal


def depth_loss_terms(output: torch.Tensor, depth: torch.Tensor,
                     num_valid=None) -> dict[str, torch.Tensor]:
    """Loss terms for NHWC single-channel ``output``/``depth``.

    ``num_valid``: only the first ``num_valid`` samples contribute, so the
    ``pad_last`` duplicates of an epoch's last batch carry no weight; the
    mean is Σ valid / (num_valid·H·W).
    """
    n = output.shape[0]
    mask = sample_mask(n, num_valid, output.device).reshape(
        (n,) + (1,) * (output.dim() - 1))
    denom = mask.sum() * output[0].numel()
    maps = depth_loss_maps(output, depth)
    return {name: (term * mask).sum() / denom
            for name, term in zip(("depth", "dx", "dy", "normal"), maps)}


def depth_loss(output: torch.Tensor, depth: torch.Tensor,
               num_valid=None) -> torch.Tensor:
    t = depth_loss_terms(output, depth, num_valid)
    return t["depth"] + t["normal"] + (t["dx"] + t["dy"])
