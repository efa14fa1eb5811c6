"""The port's serving forms (``apps/common.py``) against the JAX package's,
on the CPU: the three depthwise modes, the staged form under each MFF
merge, the tiled form (tile 2, batch 5, so that a remainder runs), the
built-in serving rule, and the resizes ``upsample_align_corners`` and
``resize_nearest_torch``.

ENB0-HU at 64×96 with random weights (``test_torch_midas.random_variables``:
every BatchNorm fold non-trivial), f32. Tolerance rtol 1e-3, atol 1e-4, as
``test_torch_models.py`` holds the monolithic forward; the port's own forms
against each other 1e-5 (the same operations, grouped or ordered
otherwise).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.apps import common as jax_common
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)
from efficientdepthestimation_tpu.ops import resize as jax_resize

from efficientdepthestimation_tpu_torch.apps.common import (
    MFF_MERGES,
    TILE_ABOVE,
    make_infer_fn,
    make_serving_fn,
    make_staged_infer_fn,
    make_tiled_infer_fn,
    serving_form,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.hu2018 import mff_apply_merged
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.ops import conv
from efficientdepthestimation_tpu_torch.ops.conv import (
    conv2d,
    depthwise_impl,
    depthwise_mode,
)
from efficientdepthestimation_tpu_torch.ops.resize import (
    resize_nearest_torch,
    upsample_align_corners,
)

from test_torch_midas import random_variables

TOL = dict(rtol=1e-3, atol=1e-4)
SAME_TOL = dict(rtol=1e-5, atol=1e-5)
INPUT_HW = (64, 96)
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch intra-op threads a worker: the suite runs its files in
    parallel workers, where torch's default of one thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def enb0_hu():
    jm = jax_build_model("efficientnet-b0", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=5)
    model = build_model("efficientnet-b0", "hu2018")
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    x = np.random.default_rng(6).standard_normal(
        (BATCH, *INPUT_HW, 3)).astype(np.float32)
    ours = make_infer_fn(model, device="cpu")(torch.from_numpy(x)).numpy()
    return jm, variables, model.eval(), x, ours


@pytest.mark.parametrize("jax_mode", ["xla", "shift"])
def test_depthwise_modes_match_jax(enb0_hu, jax_mode):
    """Each of the port's three modes against JAX's mode of the same name
    ("pallas" against both), and the port's modes against each other."""
    jm, variables, model, x, ours_pallas = enb0_hu
    ref = np.asarray(jax_common.make_infer_fn(jm, variables,
                                              dw_impl=jax_mode)(
        jnp.asarray(x)))
    ours = make_infer_fn(model, device="cpu", dw_impl=jax_mode)(
        torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (BATCH, 32, 48, 1)
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours_pallas, ref, **TOL)
    np.testing.assert_allclose(ours, ours_pallas, **SAME_TOL)


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, ((0, 1), (0, 1))),
                                        (1, 2), (2, ((1, 2), (1, 2)))])
def test_shift_equals_grouped_conv(stride, pad):
    """The per-tap form against cuDNN's (here the CPU's) grouped conv in
    f32 within 1e-5, at EfficientNet's depthwise shapes and paddings."""
    g = torch.Generator().manual_seed(7)
    k = 3 if pad in (1, ((0, 1), (0, 1))) else 5
    x = torch.randn(2, 15, 19, 48, generator=g)
    w = torch.randn(48, 1, k, k, generator=g) / k
    bias = torch.randn(48, generator=g)
    ref = conv2d(x, w, stride=stride, padding=pad, groups=48, bias=bias)
    with depthwise_impl("shift"):
        out = conv2d(x, w, stride=stride, padding=pad, groups=48, bias=bias)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    with depthwise_impl("shift"):  # dense and grouped convs are untouched
        assert torch.equal(conv2d(x, w.expand(48, 48, k, k).contiguous(),
                                  padding=k // 2),
                           conv2d(x, w.expand(48, 48, k, k).contiguous(),
                                  padding=k // 2))
    with pytest.raises(ValueError, match="unknown depthwise impl"):
        with depthwise_impl("fast"):
            pass


def test_mode_is_entered_on_every_call(enb0_hu, monkeypatch):
    """A fn built under a mode holds it for its own calls, whatever mode
    the caller is in, and leaves the caller's mode as it was."""
    _, _, model, x, _ = enb0_hu
    calls = []
    shifted = conv._depthwise_shifted
    monkeypatch.setattr(conv, "_depthwise_shifted",
                        lambda *a: calls.append(1) or shifted(*a))
    fn = make_staged_infer_fn(model, device="cpu", dw_impl="shift")
    with depthwise_impl("xla"):
        fn(torch.from_numpy(x[:1]))
        assert depthwise_mode() == "xla"
    assert len(calls) == 16 and depthwise_mode() == "pallas"
    make_infer_fn(model, device="cpu", dw_impl="xla")(torch.from_numpy(x[:1]))
    with depthwise_impl("shift"):
        make_infer_fn(model, device="cpu")(torch.from_numpy(x[:1]))
    assert len(calls) == 16


@pytest.mark.parametrize("merge,frames", [("module", False),
                                          ("grouped", False),
                                          ("blockdiag", True)])
def test_staged_matches_jax(enb0_hu, merge, frames):
    """Each MFF merge; with ``frames`` the serving pipeline's ends too:
    uint8 frames through the preprocess, depth upsampled to the frame
    size."""
    jm, variables, model, x, _ = enb0_hu
    kw = dict(mff_merge=merge)
    if frames:
        kw.update(preprocess=True, upsample_to=(480, 640))
        x = np.random.default_rng(8).integers(0, 256, (2, 480, 640, 3),
                                              dtype=np.uint8)
    ref = np.asarray(jax_common.make_staged_infer_fn(jm, variables, **kw)(
        jnp.asarray(x)))
    ours = make_staged_infer_fn(model, device="cpu", **kw)(
        torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **TOL)
    kw.pop("mff_merge")
    np.testing.assert_allclose(
        ours, make_infer_fn(model, device="cpu", **kw)(
            torch.from_numpy(x)).numpy(), **SAME_TOL)


def test_tiled_matches_jax(enb0_hu):
    """Tiles of 2 over a batch of 5: two full tiles and a remainder of 1,
    over the monolithic form against JAX's; over the staged form against
    the port's whole-batch forward."""
    jm, variables, model, x, _ = enb0_hu
    x5 = torch.from_numpy(np.concatenate([x, x[:2] * 0.5]))
    ref = np.asarray(jax_common.make_tiled_infer_fn(
        jm, variables, tile_batch=2, staged=False)(jnp.asarray(x5.numpy())))
    ours = make_tiled_infer_fn(model, device="cpu", tile_batch=2,
                               staged=False)(x5).numpy()
    assert ours.shape == ref.shape == (5, 32, 48, 1)
    np.testing.assert_allclose(ours, ref, **TOL)
    whole = make_infer_fn(model, device="cpu")(x5).numpy()
    for merge in MFF_MERGES:
        staged = make_tiled_infer_fn(model, device="cpu", tile_batch=2,
                                     mff_merge=merge)(x5).numpy()
        np.testing.assert_allclose(staged, whole, **SAME_TOL)


def test_merged_mff_is_the_module(enb0_hu):
    """``mff_apply_merged`` against the MFF module's eval forward on the
    same taps, f32 and bf16 (the bf16 forms round the same values)."""
    _, _, model, x, _ = enb0_hu
    with torch.inference_mode():
        taps = model.E(torch.from_numpy(x))
        size = (taps[0].shape[1] * 2, taps[0].shape[2] * 2)
        ref = model.MFF(taps, size)
        for block_diag in (False, True):
            out = mff_apply_merged(model.MFF, taps, size,
                                   block_diag=block_diag)
            torch.testing.assert_close(out, ref, **SAME_TOL)
        mb = build_model("efficientnet-b0", "hu2018").eval()
        mb.load_state_dict(model.state_dict())
        mb = mb.to(torch.bfloat16)
        taps = tuple(t.to(torch.bfloat16) for t in taps)
        ref = mb.MFF(taps, size).float()
        out = mff_apply_merged(mb.MFF, taps, size).float()
        torch.testing.assert_close(out, ref, rtol=1e-2, atol=1e-2)


def test_non_hu_staged_is_monolithic():
    model = build_model("resnet18", "lasinger2019", input_size=(32, 48),
                        output_size=(16, 24))
    x = torch.randn(2, 32, 48, 3)
    assert torch.equal(make_staged_infer_fn(model, device="cpu")(x),
                       make_infer_fn(model, device="cpu")(x))
    with pytest.raises(ValueError, match="mff_merge"):
        make_staged_infer_fn(model, device="cpu", mff_merge="dense")


def test_serving_rule(enb0_hu):
    """Without a policy, ``make_serving_fn`` serves the rule's form at the
    hinted batch, whatever the model: monolithic, tiles of ``TILE_ABOVE``
    above it; without a hint, the monolithic fn."""
    _, _, model, x, ours = enb0_hu
    midas = build_model("resnet18", "lasinger2019", input_size=(32, 48),
                        output_size=(16, 24))
    assert serving_form(1) == serving_form(TILE_ABOVE) == {
        "path": "monolithic"}
    assert serving_form(TILE_ABOVE + 1) == {"path": "tiled",
                                            "tile_batch": TILE_ABOVE}
    for m, batch in ((model, 3), (model, TILE_ABOVE + 1), (midas, 3)):
        fn = make_serving_fn(m, batch_hint=batch, device="cpu")
        assert fn.spec == dict(serving_form(batch), dw_impl="pallas",
                               int8=False, bake_weights=True)
    np.testing.assert_array_equal(
        make_serving_fn(model, batch_hint=BATCH, device="cpu",
                        bake_weights=False)(torch.from_numpy(x)).numpy(),
        ours)
    assert not hasattr(make_serving_fn(model, device="cpu"), "spec")
    for kw in (dict(batch_hint=BATCH), dict(bake_weights=True)):
        baked = make_serving_fn(model, device="cpu", **kw)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(baked, ours, rtol=0,
                                   atol=1e-5 * np.abs(ours).max())


@pytest.mark.parametrize("in_hw,out_hw", [
    ((5, 7), (11, 14)), ((6, 8), (13, 9)), ((9, 11), (4, 5)),
    ((8, 8), (8, 8)), ((1, 3), (2, 7)), ((7, 6), (3, 12)),
])
def test_resizes_match_jax(in_hw, out_hw):
    """``resize_nearest_torch`` (torch's nearest) and
    ``upsample_align_corners`` (factors 2 and 3) against JAX's, growing and
    shrinking, odd and even sizes: nearest exactly, the bilinear to
    1e-6."""
    x = np.random.default_rng(9).standard_normal(
        (2, *in_hw, 3)).astype(np.float32)
    ref = np.asarray(jax_resize.resize_nearest_torch(jnp.asarray(x), out_hw))
    ours = resize_nearest_torch(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(ours, ref)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(ours, torch.nn.functional.interpolate(
        t, size=out_hw, mode="nearest").permute(0, 2, 3, 1).numpy())
    for factor in (2, 3):
        ref = np.asarray(jax_resize.upsample_align_corners(jnp.asarray(x),
                                                           factor))
        ours = upsample_align_corners(torch.from_numpy(x), factor).numpy()
        assert ours.shape == (2, in_hw[0] * factor, in_hw[1] * factor, 3)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
