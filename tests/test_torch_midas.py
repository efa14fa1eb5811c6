"""The port's ResNet encoder, MiDaS decoder, pooling and Discriminator
against the JAX modules, random weights, on the CPU.

The JAX variable tree comes from ``jax.eval_shape`` of the module's init,
filled from a seeded numpy generator with the init's own distributions
(PyTorch's default conv init, U(±1/√fan_in)) and BatchNorm statistics off
identity so that every fold is non-trivial; ``from_jax_variables`` gives
the port the same weights. Nothing of the init is compiled, only the
forward. Small inputs keep the CPU time low. Tolerance rtol 1e-3, atol
1e-4 (as ``test_parity_full_size.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.models import midas as jax_midas
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)
from efficientdepthestimation_tpu.models.resnet import (
    ResNetFeatures as JaxResNetFeatures,
    resnet_block_channels as jax_resnet_block_channels,
)
from efficientdepthestimation_tpu.ops.conv import (
    avg_pool_global as jax_avg_pool_global,
    max_pool as jax_max_pool,
)

from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.midas import (
    Discriminator,
    MidasDecoder,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.models.resnet import (
    RESNET_LAYERS,
    ResNetFeatures,
    resnet_block_channels,
)
from efficientdepthestimation_tpu_torch.ops.conv import (
    avg_pool_global,
    max_pool,
)

TOL = dict(rtol=1e-3, atol=1e-4)
INPUT_HW = (64, 96)


def random_variables(module, *args, seed: int) -> dict:
    """Numpy variables of ``module.init(key, *args)``'s tree: conv kernels
    and biases U(±1/√fan_in), BN scale 1 ± 0.2, bias and mean ± 0.2,
    variance 0.5-1.5."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.default_rng(seed)
    fan_in = {}

    def fill(path, leaf):
        names = [p.key for p in path]
        name, owner = names[-1], tuple(names[:-1])
        if name == "kernel":
            fan_in[owner] = int(np.prod(leaf.shape[:-1]))
            bound = 1 / np.sqrt(fan_in[owner])
            return rng.uniform(-bound, bound, leaf.shape).astype(leaf.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name == "scale":
            return (1 + rng.uniform(-0.2, 0.2, leaf.shape)).astype(leaf.dtype)
        if name == "bias" and owner in fan_in:  # a conv's, filled after it
            bound = 1 / np.sqrt(fan_in[owner])
            return rng.uniform(-bound, bound, leaf.shape).astype(leaf.dtype)
        return rng.uniform(-0.2, 0.2, leaf.shape).astype(leaf.dtype)

    # kernels before biases, so each conv bias knows its fan-in
    kernels_first = sorted(
        jax.tree_util.tree_flatten_with_path(shapes)[0],
        key=lambda kv: kv[0][-1].key != "kernel")
    filled = {tuple(p.key for p in path): fill(path, leaf)
              for path, leaf in kernels_first}
    return jax.tree_util.tree_map_with_path(
        lambda path, _: filled[tuple(p.key for p in path)], shapes)


def _load(module, variables) -> torch.nn.Module:
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


def _inputs(shape, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_taps(ours, ref):
    assert len(ours) == len(ref) == 4
    for i, (t, r) in enumerate(zip(ours, ref)):
        assert tuple(t.shape) == r.shape, f"tap {i}"
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL,
                                   err_msg=f"tap {i}")


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("padding", [0, 1])
def test_max_pool_matches_jax(padding, ceil_mode):
    # In ceil mode a partial last window is kept (3x3/2 over a width of 12,
    # or of 14 with padding 1), and with padding 1 a 2x2/2 window that
    # would start in the right padding is dropped (over 5 rows).
    shapes = []
    for window, hw in ((3, (9, 12)), (3, (10, 13)), (2, (5, 7))):
        x = _inputs((2, *hw, 5))
        ref = jax_max_pool(jnp.asarray(x), window, 2, padding=padding,
                           ceil_mode=ceil_mode)
        out = max_pool(torch.from_numpy(x), window, 2, padding, ceil_mode)
        assert tuple(out.shape) == ref.shape
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        shapes.append(tuple(out.shape[1:3]))
    expected = {(0, False): [(4, 5), (4, 6), (2, 3)],
                (0, True): [(4, 6), (5, 6), (3, 4)],
                (1, False): [(5, 6), (5, 7), (3, 4)],
                (1, True): [(5, 7), (6, 7), (3, 4)]}
    assert shapes == expected[(padding, ceil_mode)]


def test_avg_pool_global_matches_jax():
    x = _inputs((3, 7, 9, 4))
    for keepdims in (True, False):
        ref = jax_avg_pool_global(jnp.asarray(x), keepdims=keepdims)
        out = avg_pool_global(torch.from_numpy(x), keepdims)
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("variant", sorted(RESNET_LAYERS))
def test_resnet_block_channels_match_jax(variant):
    assert resnet_block_channels(variant) == \
        jax_resnet_block_channels(variant)


def test_resnet18_taps_match_jax():
    jm = JaxResNetFeatures(variant="resnet18")
    x = _inputs((2, *INPUT_HW, 3))
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=1)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        ours = _load(ResNetFeatures("resnet18"), variables)(
            torch.from_numpy(x))
    _check_taps(ours, ref)
    # 228x304 gives 57x76 ... 8x10; at 64x96, 16x24, 8x12, 4x6, 2x3
    assert [tuple(t.shape[1:3]) for t in ours] == [(16, 24), (8, 12),
                                                   (4, 6), (2, 3)]


@pytest.mark.parametrize("encoder,decoder,encoder_key", [
    ("resnet50", "hu2018", "E"),
    ("resnet50", "lasinger2019", "encoder"),
    ("efficientnet-b0", "lasinger2019", "encoder"),
])
def test_model_matches_jax(encoder, decoder, encoder_key):
    """The encoder's taps and the output: RN50-HU, RN50-LR and ENB0-LR at
    full width and depth on 64x96 inputs (MiDaS output size 32x48)."""
    size = dict(output_size=(32, 48), input_size=INPUT_HW)
    kw = size if decoder == "lasinger2019" else {}
    jm = jax_build_model(encoder, decoder, **kw)
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=3)
    model = _load(build_model(encoder, decoder, **kw), variables)
    x = _inputs((2, *INPUT_HW, 3), seed=4)
    enc_vars = {c: variables[c][encoder_key] for c in variables}
    ref_taps = jax.jit(jm.encoder_factory().apply)(enc_vars, jnp.asarray(x))
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    encoder_module = model.E if decoder == "hu2018" else model.encoder
    with torch.inference_mode():
        taps = encoder_module(torch.from_numpy(x))
        out = model(torch.from_numpy(x)).numpy()
    _check_taps(taps, ref_taps)
    assert out.shape == ref.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(out, ref, **TOL)


def test_bottleneck_decoder_matches_jax():
    """``block_type="bottleneck"``, ``non_negative=True`` and an explicit
    ``num_features`` (12, not the first tap's 8): projections where the
    tap's channels differ from 12, none where they equal it."""
    channels = (8, 12, 24, 32)
    shapes = [(2, 16, 24, 8), (2, 8, 12, 12), (2, 4, 6, 24), (2, 2, 3, 32)]
    taps = [_inputs(s, seed=10 + i) for i, s in enumerate(shapes)]
    jm = jax_midas.MidasDecoder(channels, 12, True, "bottleneck")
    out_size = (30, 44)
    variables = random_variables(
        jm, [jnp.zeros(s) for s in shapes], out_size, False, seed=5)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, out_size))(
        variables, [jnp.asarray(t) for t in taps]))
    model = _load(MidasDecoder(channels, 12, True, "bottleneck"), variables)
    assert model.blocks[0].res_block1.down_sample is not None
    assert model.blocks[2].res_block1.down_sample is None  # 12 -> 12
    with torch.inference_mode():
        out = model([torch.from_numpy(t) for t in taps], out_size).numpy()
    assert out.shape == ref.shape == (2, *out_size, 1)
    assert out.min() >= 0 and (ref == 0).any()
    np.testing.assert_allclose(out, ref, **TOL)


def test_deepest_block_never_runs_its_res_block2():
    """The reference builds ``blocks.0.res_block2`` and never calls it: the
    output does not change when its weights are NaN."""
    channels = (8, 12, 24, 32)
    taps = [torch.from_numpy(_inputs(s, seed=20 + i)) for i, s in enumerate(
        [(1, 8, 12, 8), (1, 4, 6, 12), (1, 2, 3, 24), (1, 1, 2, 32)])]
    model = MidasDecoder(channels).eval()
    with torch.inference_mode():
        before = model(taps, (16, 24))
        for p in model.blocks[0].res_block2.parameters():
            p.fill_(float("nan"))
        after = model(taps, (16, 24))
    assert torch.equal(before, after)


def test_discriminator_matches_jax():
    jm = jax_midas.Discriminator()
    x = _inputs((2, 40, 48, 4), seed=6)
    variables = random_variables(jm, jnp.zeros((1, 40, 48, 4)), False,
                                 seed=7)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = _load(Discriminator(), variables)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out, ref, **TOL)
