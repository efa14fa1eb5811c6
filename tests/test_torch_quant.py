"""The port's dynamic int8 (``ops/quant.py``) against the JAX package's, on
the CPU.

* ``quant_conv2d`` on the same inputs: the same integers (both round half
  to even and sum s8×s8 products exactly), so the dequantized outputs
  agree to f32 rounding, and both equal an int64 numpy oracle.
* ``should_quantize`` equal on a grid of shapes, in and out of the context.
* The model-level int8 forward of RN50-HU: the convs each package
  quantizes, and at each of them the port's int8 conv on JAX's input gives
  JAX's output; the whole forward within the cascade of int8 steps.
"""

import collections
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.apps.common import (
    make_infer_fn as jax_make_infer_fn,
)
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)
from efficientdepthestimation_tpu.ops import quant as jax_quant

from efficientdepthestimation_tpu_torch.apps.common import make_infer_fn
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.ops import quant
from efficientdepthestimation_tpu_torch.ops.conv import conv2d
from efficientdepthestimation_tpu_torch.ops.quant import (
    int_conv2d,
    quant_conv2d,
    quantize_kernel,
    quantized_convs,
    should_quantize,
)

from test_torch_midas import random_variables

# The dequantize is one f32 multiply of the same int32 sums by the same
# f32 scales, then the same bias add: equal to f32 rounding.
DEQUANT_TOL = dict(rtol=1e-6, atol=1e-6)
INPUT_HW = (32, 48)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two PyTorch intra-op threads a worker: the suite runs its files in
    parallel workers, where torch's default of one thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_quant_conv(x, k, stride, pad, bias=None):
    """The int64 numpy oracle of the scheme (tests/test_quant.py), HWIO."""
    xf = np.asarray(x, np.float64)
    kf = np.asarray(k, np.float64)
    s_x = np.float32(max(np.abs(xf).max(), 1e-30)) / np.float32(127.0)
    xq = np.clip(np.round(np.float32(x) / s_x), -127, 127).astype(np.int64)
    s_w = (np.maximum(np.abs(kf).max(axis=(0, 1, 2)), 1e-30)
           / 127.0).astype(np.float32)
    kq = np.clip(np.round(np.float32(k) / s_w), -127, 127).astype(np.int64)
    (pt, pb), (pl, pr) = pad
    xq = np.pad(xq, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    kh, kw, _, co = kq.shape
    sh, sw = stride
    b, h, w, _ = xq.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    out = np.zeros((b, oh, ow, co), np.int64)
    for i in range(kh):
        for j in range(kw):
            sl = xq[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            out += np.einsum("bhwc,co->bhwo", sl, kq[i, j], dtype=np.int64)
    y = out.astype(np.float64) * (s_x * s_w).astype(np.float64)
    if bias is not None:
        y = y + np.asarray(bias, np.float64)
    return y


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("stride,pad,cout", [
    ((1, 1), ((2, 2), (2, 2)), 32),
    ((2, 2), ((1, 1), (1, 1)), 32),
    ((1, 1), ((0, 1), (1, 0)), 1),     # the R head's one channel, uneven pad
    ((2, 1), ((0, 0), (2, 2)), 24),
])
def test_quant_conv2d_matches_jax(stride, pad, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    k = (rng.standard_normal((5, 5, 64, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    ref = np.asarray(jax_quant.quant_conv2d(
        jnp.asarray(x), jnp.asarray(k), stride=stride, padding=pad,
        bias=jnp.asarray(bias)))
    ours = quant_conv2d(torch.from_numpy(x), _oihw(k), stride=stride,
                        padding=pad, bias=torch.from_numpy(bias)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **DEQUANT_TOL)
    np.testing.assert_allclose(ours.astype(np.float64),
                               _np_quant_conv(x, k, stride, pad, bias),
                               **DEQUANT_TOL)


def test_quant_conv2d_keeps_bf16():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 128)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((8, 128, 3, 3)).astype(
        np.float32) * 0.1)
    ref = np.asarray(jax_quant.quant_conv2d(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
        padding=((1, 1), (1, 1))).astype(jnp.float32))
    ours = quant_conv2d(x, w, padding=((1, 1), (1, 1)))
    assert ours.dtype == torch.bfloat16
    # the same f32 values rounded once to bf16
    np.testing.assert_array_equal(ours.float().numpy(), ref)


def test_quantize_kernel_matches_jax():
    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    k[..., 3] *= 50.0  # one hot channel keeps the others' range
    kq_ref, sc_ref = jax_quant.quantize_kernel(jnp.asarray(k))
    kq, sc = quantize_kernel(_oihw(k))
    assert kq.dtype == torch.int8 and sc.shape == (16,)
    np.testing.assert_array_equal(kq.numpy(),
                                  np.asarray(kq_ref).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))


def test_int_conv2d_sums_exactly():
    """The int32 conv of both routes (stride 1: rows of the padded input;
    other strides: copied slices) against an int64 conv, and ``_int_mm``'s
    zero padding of fewer than 17 rows and of one output channel."""
    g = torch.Generator().manual_seed(2)
    for stride, pad, shape in (((1, 1), ((2, 2), (2, 2)), (2, 9, 11)),
                               ((2, 2), ((1, 2), (0, 1)), (1, 9, 8)),
                               ((1, 1), ((0, 0), (0, 0)), (1, 5, 5))):
        x = torch.randint(-127, 128, (*shape, 128), generator=g,
                          dtype=torch.int8)
        for co in (1, 3, 16):
            k = torch.randint(-127, 128, (co, 128, 5, 5), generator=g,
                              dtype=torch.int8)
            y = int_conv2d(x, k, stride, pad)
            (pt, pb), (pl, pr) = pad
            ref = torch.nn.functional.conv2d(
                torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                        (pl, pr, pt, pb)),
                k.double(), stride=stride).permute(0, 2, 3, 1)
            assert y.dtype == torch.int32 and y.shape == ref.shape
            assert torch.equal(y.double(), ref), (stride, pad, co)


def test_should_quantize_matches_jax():
    shapes = [(kh, kh, cin, cout) for kh in (1, 3, 5)
              for cin in (64, 128, 130, 256, 1024, 2048) for cout in (1, 64)]
    cases = [(s, g, d) for s in shapes for g in (1, 2, 4)
             for d in ((1, 1), (2, 2))]
    for macs in (None, 1600, 4000):
        off = contextlib.nullcontext
        with (quantized_convs(macs) if macs else off()), \
                (jax_quant.quantized_convs(macs) if macs else off()):
            assert quant.quant_enabled() == jax_quant.quant_enabled()
            for shape, groups, dil in cases:
                assert should_quantize(shape, groups, dil) == \
                    jax_quant.should_quantize(shape, groups, dil), \
                    (macs, shape, groups, dil)
    assert not should_quantize((5, 5, 128, 32), 1, (1, 1))


def test_conv2d_routes_through_gate():
    """Under ``quantized_convs`` an eligible conv is ``quant_conv2d``'s,
    an ineligible one bit for bit the float conv; outside it, nothing
    changes."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 8, 8, 128, generator=g)
    w_big = torch.randn(32, 128, 5, 5, generator=g) * 0.1
    w_small = torch.randn(32, 128, 3, 3, generator=g) * 0.1
    base_big = conv2d(x, w_big, padding=2)
    base_small = conv2d(x, w_small, padding=1)
    with quantized_convs():
        q_big = conv2d(x, w_big, padding=2)
        q_small = conv2d(x, w_small, padding=1)
    assert torch.equal(base_small, q_small)
    assert torch.equal(q_big, quant_conv2d(x, w_big,
                                           padding=((2, 2), (2, 2))))
    rel = float((q_big - base_big).norm() / base_big.norm())
    assert 0 < rel < 0.02
    assert torch.equal(conv2d(x, w_big, padding=2), base_big)


def _record(module, attr, shapes, calls=None):
    """Wrap ``module.attr`` (a quant_conv2d) to record each call's input
    shape and HWIO kernel shape; with ``calls`` (JAX), also its input,
    kernel, bias and output as the program runs them (``calls[i]`` for
    the i-th site, by a debug callback). Returns the original."""
    saved = getattr(module, attr)

    def wrapped(x, k, **kw):
        out = saved(x, k, **kw)
        hwio = (tuple(k.shape) if module is jax_quant
                else tuple(k.permute(2, 3, 1, 0).shape))
        if calls is not None:
            static = {n: v for n, v in kw.items() if n != "bias"}
            bias = kw.get("bias")

            def store(xv, kv, ov, *bv, i=len(shapes)):
                calls[i] = (np.array(xv, np.float32), np.array(kv), static,
                            np.array(bv[0]) if bv else None,
                            np.array(ov, np.float32))

            jax.debug.callback(store, x, k, out,
                               *(() if bias is None else (bias,)))
        shapes.append((tuple(x.shape[1:]), hwio))
        return out

    setattr(module, attr, wrapped)
    return saved


@pytest.fixture(scope="module")
def rn50_hu():
    jm = jax_build_model("resnet50", "hu2018")
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=3)
    model = build_model("resnet50", "hu2018")
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    x = np.random.default_rng(4).standard_normal(
        (2, *INPUT_HW, 3)).astype(np.float32)
    return jm, variables, model.eval(), x


def test_int8_sites_match_jax(rn50_hu):
    """RN50-HU in bf16: each package's int8 forward quantizes the same
    convs (the same input and kernel shapes, as often), JAX's list taken
    from its own ``should_fuse`` and ``should_quantize`` as its forward
    runs them. In bf16 the port's rule (``ops/fused.py``) sends D.up4 to
    the kernel, whose site the int8 conv takes, as JAX's direct
    composition at D.up4 quantizes it; in f32 the port takes the einsum
    route there, which stays float in both packages."""
    jm, variables, model, x = rn50_hu
    jax_sites, ours = [], []
    saved = _record(jax_quant, "quant_conv2d", jax_sites)
    try:
        out_j = jax_make_infer_fn(jm, variables, int8=True,
                                  dtype=jnp.bfloat16)(jnp.asarray(x))
    finally:
        jax_quant.quant_conv2d = saved
    saved = _record(quant, "quant_conv2d", ours)
    try:
        out = make_infer_fn(model, int8=True, dtype=torch.bfloat16,
                            device="cpu")(torch.from_numpy(x))
    finally:
        quant.quant_conv2d = saved
    assert len(ours) == 18
    assert collections.Counter(ours) == collections.Counter(jax_sites)
    assert ((16, 24, 128), (5, 5, 128, 128)) in ours  # D.up4's kernel site
    assert np.isfinite(np.asarray(out_j)).all()
    assert torch.isfinite(out).all()


def test_int8_forward_matches_jax(rn50_hu, monkeypatch):
    """RN50-HU in f32, each UpProjection on JAX's route (the port's
    ``should_fuse`` answered by JAX's, so that both quantize the same 18
    convs): at every site, on the input and kernel JAX's forward gives it,
    the port's int8 conv gives JAX's output to f32 rounding (DEQUANT_TOL)
    but where JAX's compiled program forms x/s_x otherwise and rounds a
    quotient on a half to the other integer (at two sites, 2 outputs of
    1024 and of 3072): those, at most 1 in 100, within the step s_x·max|k| that
    moves them (uncompiled, JAX's ``quant_conv2d`` rounds as the port
    does: ``test_quant_conv2d_matches_jax``); the forwards
    differ by int8 steps that f32 rounding (the float forwards agree to
    2e-6) moves across, carried through 18 quantized layers: 0.016 of the
    output's norm measured, held to 0.03, JAX's int8 ceiling
    (tests/test_quant.py); the port's distance from JAX's float output
    also within 0.03."""
    from efficientdepthestimation_tpu.ops.fused import (
        should_fuse as jax_should_fuse,
    )
    from efficientdepthestimation_tpu_torch.models import hu2018

    jm, variables, model, x = rn50_hu
    monkeypatch.setattr(hu2018, "should_fuse",
                        lambda i, o, c, f, dtype: jax_should_fuse(i, o, c, f))
    jax_sites, calls, ours = [], {}, []
    saved = _record(jax_quant, "quant_conv2d", jax_sites, calls)
    try:
        with jax_quant.quantized_convs():
            out_j = np.asarray(jax.jit(
                lambda v, x: jm.apply(v, x, False))(variables,
                                                     jnp.asarray(x)))
    finally:
        jax_quant.quant_conv2d = saved
    saved = _record(quant, "quant_conv2d", ours)
    try:
        out = make_infer_fn(model, int8=True, device="cpu")(
            torch.from_numpy(x)).numpy()
    finally:
        quant.quant_conv2d = saved
    assert len(ours) == 18 and ours == jax_sites and len(calls) == 18
    for xj, kj, kw, bias, yj in calls.values():
        y = quant_conv2d(
            torch.from_numpy(xj), _oihw(kj), **kw,
            bias=None if bias is None else torch.from_numpy(bias)).numpy()
        close = np.isclose(y, yj, **DEQUANT_TOL)
        step = np.abs(xj).max() / 127 * np.abs(kj).max()
        assert close.mean() >= 0.99
        assert np.abs(y - yj)[~close].max(initial=0) <= step
    ref_float = np.asarray(jax_make_infer_fn(jm, variables)(jnp.asarray(x)))
    norm = np.linalg.norm(out_j)
    assert np.linalg.norm(out - out_j) / norm <= 0.03
    assert np.linalg.norm(out - ref_float) / np.linalg.norm(ref_float) \
        <= 0.03
