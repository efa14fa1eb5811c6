"""Constant-baked serving (``bake_weights``) of the port, on the CPU.

The eight configurations baked against unbaked at 64×96 (f32 within 1e-5
of max|out|, bf16 within the bf16 tolerances ``chip_smoke.py`` holds the
card to); ENB0-HU and RN50-HU baked against the JAX package's
``make_infer_fn(bake_weights=True)`` on the same weights; a baked fn
keeps the weights it was built with; ``make_serving_fn`` bakes exactly
when the JAX package's does (C7); policy entries that bake; and the
autotuner's ``+bake`` candidates against the JAX package's list.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdepthestimation_tpu.apps import autotune as jax_autotune
from efficientdepthestimation_tpu.apps import common as jax_common
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)

from efficientdepthestimation_tpu_torch.apps import autotune
from efficientdepthestimation_tpu_torch.apps import common
from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
    make_infer_fn,
    make_serving_fn,
    make_staged_infer_fn,
    make_tiled_infer_fn,
)
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    to_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.common import (
    BatchNorm,
    FoldedNorm,
    bake_,
    randomize_,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model

from test_torch_autotune import CONFIGS, ROOT

CHECKPOINT = f"{ROOT}/e2e/ENB0-HU-synthetic.ede"
HW = (64, 96)
F32_REL = 1e-5
# chip_smoke.py's BF16_RANDOM_MAX_REL / BF16_RANDOM_MEAN_REL: a bf16
# output against another of the same model, relative to its max |value|.
BF16_MAX_REL, BF16_MEAN_REL = 0.15, 0.03
JAX_ATOL_M = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal(
        (2, *HW, 3)).astype(np.float32)


def _model(encoder, decoder, seed):
    kw = (dict(input_size=HW, output_size=(HW[0] // 2, HW[1] // 2))
          if decoder == "lasinger2019" else {})
    return randomize_(build_model(encoder, decoder, **kw), seed)


@pytest.mark.parametrize("encoder,decoder", CONFIGS)
def test_baked_matches_unbaked(encoder, decoder, images):
    model = _model(encoder, decoder, CONFIGS.index((encoder, decoder)))
    x = torch.from_numpy(images)
    for dtype in (None, torch.bfloat16):
        ref = make_infer_fn(model, device="cpu", dtype=dtype)(x)
        out = make_infer_fn(model, device="cpu", dtype=dtype,
                            bake_weights=True)(x)
        scale = ref.abs().max()
        err = (out - ref).abs() / scale
        if dtype is None:
            assert err.max() <= F32_REL, (encoder, decoder)
        else:
            assert err.max() <= BF16_MAX_REL and err.mean() <= BF16_MEAN_REL


def test_bake_folds_every_batch_norm():
    """No BatchNorm is left: each conv → BN pair folded into the conv (an
    ``nn.Identity`` in the BN's place), each other BN a ``FoldedNorm`` kept
    in f32 while the rest is cast; the depthwise taps and the stacked
    UpProjection kernels precomputed."""
    model = bake_(randomize_(build_model("efficientnet-b0", "hu2018"), 1),
                  torch.bfloat16)
    assert not any(isinstance(m, BatchNorm) for m in model.modules())
    kept = [m for m in model.modules() if isinstance(m, FoldedNorm)]
    assert len(kept) == 16  # the depthwise kernel's BNs
    assert all(m.scale.dtype == torch.float32 for m in kept)
    block = model.E._blocks[3]
    assert isinstance(block._bn0, torch.nn.Identity)
    assert block.baked_taps.shape == (5, 5, 144)
    assert block._project_conv.bias.dtype == torch.bfloat16
    up = model.D.up2
    assert up.baked_kernels.shape == (5, 5, up.conv1.weight.shape[1],
                                      2 * up.features)
    dn = bake_(randomize_(build_model("densenet161", "hu2018"), 2))
    assert isinstance(dn.E.features["norm0"], torch.nn.Identity)
    assert isinstance(dn.E.features["transition1"]["norm"], FoldedNorm)


@pytest.mark.parametrize("encoder", ["efficientnet-b0", "resnet50"])
def test_baked_matches_jax_baked(encoder, images):
    """ENB0-HU from its ``.ede``, RN50-HU with seeded random weights: the
    port's baked forward against the JAX package's baked ``make_infer_fn``
    on the same weights, f32, within 1e-4 m."""
    if encoder == "efficientnet-b0":
        model = load_any_checkpoint(CHECKPOINT, device="cpu")
    else:
        model = randomize_(build_model(encoder, "hu2018"), 6)
    jax_model = jax_build_model(encoder, "hu2018")
    variables = to_jax_variables(model.state_dict())
    want = np.asarray(jax_common.make_infer_fn(
        jax_model, variables, bake_weights=True)(jnp.asarray(images)))
    got = make_infer_fn(model, device="cpu", bake_weights=True)(
        torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL_M)


@pytest.mark.parametrize("maker", [make_infer_fn, make_staged_infer_fn,
                                   make_tiled_infer_fn])
def test_baked_fn_ignores_later_edits(maker, images):
    """The fn is bound to the weights as they were when it was built."""
    model = randomize_(build_model("resnet18", "hu2018"), 3).eval()
    x = torch.from_numpy(images)
    kw = dict(tile_batch=1) if maker is make_tiled_infer_fn else {}
    fn = maker(model, device="cpu", bake_weights=True, **kw)
    before = fn(x)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
        model.D.bn.running_mean.add_(1.0)
    assert torch.equal(fn(x), before)
    assert not torch.allclose(maker(model, device="cpu", bake_weights=True,
                                    **kw)(x), before)


def _recorders(monkeypatch):
    """Record the ``bake_weights`` each package's serving fn is built with,
    without building it."""
    seen = {"jax": [], "torch": []}

    def jax_maker(*args, bake_weights=False, **kw):
        seen["jax"].append(bool(bake_weights))
        return lambda images: images

    for module in (jax_common, jax_autotune):
        for name in ("make_infer_fn", "make_staged_infer_fn",
                     "make_tiled_infer_fn"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, jax_maker)
    real = common._serving_copy

    def torch_copy(model, device, dtype, bake_weights=False):
        seen["torch"].append(bool(bake_weights))
        return real(model, device, dtype, bake_weights)

    monkeypatch.setattr(common, "_serving_copy", torch_copy)
    return seen


@pytest.mark.parametrize("batch_hint", [None, 4, 256])
@pytest.mark.parametrize("bake", [None, False, True])
def test_make_serving_fn_bakes_as_jax_does(batch_hint, bake, monkeypatch):
    """C7: ``bake_weights=None`` bakes whenever ``batch_hint`` is given, in
    both packages; an explicit value is followed. (The JAX package's
    200 MB override does not apply to this small model.)"""
    seen = _recorders(monkeypatch)
    model = build_model("resnet18", "hu2018")
    jax_common.make_serving_fn(jax_build_model("resnet18", "hu2018"), {},
                               batch_hint=batch_hint, bake_weights=bake)
    make_serving_fn(model, batch_hint=batch_hint, bake_weights=bake,
                    device="cpu")
    assert seen["torch"][-1] == seen["jax"][-1] == (
        bool(bake) if bake is not None else batch_hint is not None)


@pytest.mark.parametrize("stored", [True, False, None])
def test_policy_entry_bakes_as_jax_does(stored, tmp_path, monkeypatch):
    """A policy entry's ``bake_weights`` decides its form in both packages
    (an entry without the key takes the passed value, ``False`` for
    ``None``)."""
    seen = _recorders(monkeypatch)
    model = build_model("resnet18", "hu2018")
    jmodel = jax_build_model("resnet18", "hu2018")
    entry = {"path": "monolithic", "dw_impl": "xla", "int8": False}
    if stored is not None:
        entry["bake_weights"] = stored
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jpath.write_text(json.dumps(
        {jax_autotune.policy_key(jmodel, 4, None): entry}))
    tpath.write_text(json.dumps(
        {autotune.policy_key(model, 4, None, "cpu"): entry}))
    jax_common.make_serving_fn(jmodel, {}, batch_hint=4,
                               policy_path=str(jpath))
    fn = make_serving_fn(model, batch_hint=4, policy_path=str(tpath),
                         device="cpu")
    assert seen["torch"][-1] == seen["jax"][-1] == bool(stored)
    assert fn.spec["bake_weights"] is bool(stored)


def test_bake_candidates_extend_jax_list():
    """The JAX package's candidate names in its order, and a ``+bake``
    variant of each port lowering JAX does not bake ("shift", "pallas")."""
    from test_torch_autotune import _models

    ours, theirs = _models("efficientnet-b0", "hu2018")
    names = [n for n, _ in autotune._serving_candidates(ours, 256)]
    want = [n for n, _ in jax_autotune._serving_candidates(theirs, 256)]
    extra = [n for n in names if n not in want]
    assert [n for n in names if n in want] == want
    assert extra == [f"{n}+bake" for n in names
                     if "+" not in n and "/xla" not in n]
