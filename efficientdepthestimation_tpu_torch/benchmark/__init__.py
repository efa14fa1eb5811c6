"""User-centred benchmark harness (Benchmark/ in the reference).

Counterpart of ``efficientdepthestimation_tpu/benchmark``: depth-accuracy
metrics plus perceptual metrics (SSIM / PSNR / LPIPS / MIFD) computed on
novel views rendered from predicted depth, a perlin-noise baseline, result
reporting (CSV/LaTeX/plots) and comparison grids.
"""

from efficientdepthestimation_tpu_torch.benchmark.depth_model import (
    DepthModel,
    FlatDepthEstimator,
    ReSIDEModel,
    MidasModel,
)
from efficientdepthestimation_tpu_torch.benchmark.metrics import (
    ssim,
    psnr,
    VisualMetricsTracker,
)
