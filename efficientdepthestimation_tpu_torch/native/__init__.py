"""Native (C++) host I/O: the batch image decoder and the image and video
encoders, counterparts of ``efficientdepthestimation_tpu/native/``.

The C++ sources in ``csrc/`` are the JAX package's, copied. Each is built
with g++ at its first use into ``_build/`` (``native.build``) and bound
with ctypes; nothing is built at import. Callers check ``is_available()``
or ``encoder.is_available()`` and take the PIL or cv2 route when the
library cannot be built, as the JAX package's callers do. These are
numpy-in, numpy-out host functions: nothing here touches the card.
"""

from efficientdepthestimation_tpu_torch.native import encoder
from efficientdepthestimation_tpu_torch.native.loader import (
    build_error,
    build_library,
    decode_depth16_batch,
    decode_rgb_batch,
    is_available,
)

__all__ = ["encoder", "build_error", "build_library", "decode_depth16_batch",
           "decode_rgb_batch", "is_available"]
