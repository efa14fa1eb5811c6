"""PyTorch/CUDA port of ``efficientdepthestimation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here keeps the
name of its counterpart there. Public model and kernel functions take NHWC
tensors, as the JAX package does, so the two can be compared like with like.
Inside the models, activations are NCHW views in ``torch.channels_last``
memory, which is the same bytes as NHWC.

Entry points (``apps.common.load_any_checkpoint``, ``make_serving_fn``) run on
the CUDA card unless the caller passes ``device="cpu"``. On CPU tensors the
hand-written kernels (``ops.kernels``) run their plain PyTorch versions.
"""

# Version of the self-describing MidasNet checkpoint schema, the reference's
# lasinger2019.__version__ (ReSIDE/models/lasinger2019.py:11), as the JAX
# package writes it into its .ede headers.
MIDAS_CHECKPOINT_VERSION = "0.2.0"
