"""The port's ``.pth`` import (``checkpoints/pth_import.py``) against the JAX
package's, on the CPU.

The reference's keys come from the JAX package: its
``state_dict_from_variables`` writes them, its ``_torch_key`` names them,
and its ``import_pth`` + ``apply`` is the forward the port's
``load_any_checkpoint`` is held to. The ``.pth`` files are written here,
in each layout the reference used (a raw Hu2018 ``state_dict`` under
DataParallel's ``module.`` prefix, MidasNet's self-describing dict), from
seeded numpy weights. The cases of ``tests/test_import_fuzz.py`` are
replayed against the port.

Tolerances: forwards of the same weights, ``test_torch_midas.py``'s TOL
(rtol 1e-3, atol 1e-4); anything the port only moves (weights written and
read back, keys) must be equal.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from efficientdepthestimation_tpu.checkpoints import pth_import as jpth
from efficientdepthestimation_tpu.models.registry import (
    build_model as jax_build_model,
)

from efficientdepthestimation_tpu_torch import MIDAS_CHECKPOINT_VERSION
from efficientdepthestimation_tpu_torch.apps.common import (
    load_any_checkpoint,
)
from efficientdepthestimation_tpu_torch.checkpoints import pth_import
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
)
from efficientdepthestimation_tpu_torch.models.common import randomize_
from efficientdepthestimation_tpu_torch.models.registry import build_model

from test_torch_midas import TOL, random_variables
from torch_tmp_cleanup import delete_tmp_path  # noqa: F401  (autouse)

RELEASED = [(enc, dec) for enc in ("efficientnet-b0", "efficientnet-b4",
                                   "resnet50")
            for dec in ("hu2018", "lasinger2019")]
INPUT_HW = (64, 96)
MIDAS_SIZES = dict(output_size=(32, 48), input_size=INPUT_HW)


def _leaf_paths(variables):
    for collection, tree in variables.items():
        for path, leaf in jpth._iter_leaf_paths(tree):
            yield collection, path, leaf


def _numbered_tree(shapes) -> dict:
    """Each leaf of a ``jax.eval_shape`` tree as a broadcast of its own
    index: a key that maps to the wrong leaf shows as a wrong value even
    where the shapes agree."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    return jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.float32(i), s.shape) for i, s in enumerate(leaves)])


def _torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _midas_dict(encoder: str, weights: dict, version=MIDAS_CHECKPOINT_VERSION
                ) -> dict:
    """The reference's MidasNet.save schema (lasinger2019.py:378-392), sizes
    WH, for a model built with ``MIDAS_SIZES``."""
    (h_out, w_out), (h_in, w_in) = MIDAS_SIZES.values()
    return {"encoder": {"name": encoder, "freeze_weights": False},
            "decoder": {"num_features": 64, "non_negative": False},
            "input_size": (w_in, h_in), "output_size": (w_out, h_out),
            "adversarial_training": False, "weights": weights,
            "version": version}


def _state_equal(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("encoder,decoder", RELEASED)
def test_reference_keys_match_jax(encoder, decoder):
    """At full width: the port's ``reference_state_dict`` has the keys of
    the JAX package's ``state_dict_from_variables``, each holding the same
    leaf (numbered), and ``load_reference_state_dict`` of JAX's
    ``state_dict`` gives back the port's."""
    jm = jax_build_model(encoder, decoder)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 228, 304, 3)),
        False))
    tree = _numbered_tree(shapes)
    ref = jpth.state_dict_from_variables(jm, tree)
    model = build_model(encoder, decoder)
    model.load_state_dict(from_jax_variables(tree), strict=True)
    ours = pth_import.reference_state_dict(model)
    assert sorted(ours) == sorted(ref)
    for key, value in ours.items():
        assert tuple(value.shape) == ref[key].shape, key
        assert float(value.reshape(-1)[0]) == float(ref[key].flat[0]), key
    loaded = pth_import.load_reference_state_dict(
        build_model(encoder, decoder), _torch_sd(ref))
    _state_equal(loaded, model)


@pytest.mark.parametrize("encoder,translator", [
    ("senet154", "_senet_hu_translator"),
    ("densenet161", "_identity_translator")])
def test_dn161_sn154_encoder_keys_match_jax(encoder, translator):
    """SN154-HU's and DN161-HU's reference keys, as strings: each JAX
    variable path through the port's translator against JAX's
    ``_torch_key``, and every SENet key vintage, with ``module.``
    prefixes, through the port's ``_fix_keys`` against JAX's."""
    jm = jax_build_model(encoder, "hu2018")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *INPUT_HW, 3))))
    translate = getattr(pth_import, translator)
    keys = []
    for collection, path, _ in _leaf_paths(shapes):
        want = jpth._torch_key(path, collection, jm)
        if want is None:
            continue
        *mods, leaf = path
        torch_leaf = jpth._LEAF_TO_TORCH[(collection, leaf)]
        assert mods[0] == "E" or not want.startswith("E.")
        got = (f"E.{translate(tuple(mods[1:]) + (torch_leaf,))}"
               if mods[0] == "E" else ".".join((*mods, torch_leaf)))
        assert got == want, path
        keys.append(want)
    se = [k for k in keys if "se_module." in k]
    assert bool(se) == (encoder == "senet154")
    vintages = [{k: 0 for k in keys},
                {k.replace("se_module.", "se_"): 0 for k in keys},
                {(f"module.{k}".replace("se_module.", "se_") if i % 2
                  else f"module.module.{k}"): 0 for i, k in enumerate(keys)}]
    for state in vintages:
        ours = pth_import._fix_keys(state, senet=True)
        assert list(ours) == list(jpth._fix_keys(state, senet=True))
        assert sorted(ours) == sorted(keys)
        assert list(pth_import._fix_keys(state)) == \
            list(jpth._fix_keys(state))


@pytest.mark.parametrize("name", ["SN154-HU", "DN161-HU"])
def test_dn161_sn154_pth_load(name, tmp_path):
    """SN154-HU and DN161-HU load from a ``.pth`` named for them: JAX's
    numbered reference keys at full width under ``module.`` (SN154-HU's SE
    keys in the released ``se_`` form), each leaf where JAX's
    ``import_pth`` puts it."""
    encoder = {"SN154-HU": "senet154", "DN161-HU": "densenet161"}[name]
    jm = jax_build_model(encoder, "hu2018")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *INPUT_HW, 3))))
    tree = _numbered_tree(shapes)
    ref = jpth.state_dict_from_variables(jm, tree)
    path = tmp_path / f"{name}.pth"
    torch.save({f"module.{k}".replace("se_module.", "se_"): v
                for k, v in _torch_sd(ref).items()}, path)
    model = load_any_checkpoint(str(path), device="cpu")
    want = from_jax_variables(tree)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key].to(value.dtype)), key


@pytest.mark.parametrize("name,encoder,decoder", [
    ("ENB0-HU", "efficientnet-b0", "hu2018"),
    ("ENB0-LR", "efficientnet-b0", "lasinger2019"),
    ("RN50-HU", "resnet50", "hu2018"),
    ("RN18-HU", "resnet18", "hu2018")])
def test_pth_forward_matches_jax_import(name, encoder, decoder, tmp_path):
    """A reference ``.pth`` of seeded numpy weights (HU: a raw
    ``state_dict`` under ``module.``; LR: the self-describing dict) through
    the port's ``load_any_checkpoint`` and through JAX's ``import_pth`` +
    ``apply``, on 64×96 inputs."""
    midas = decoder == "lasinger2019"
    kw = dict(MIDAS_SIZES, num_features=64) if midas else {}
    jm = jax_build_model(encoder, decoder, **kw)
    variables = random_variables(jm, jnp.zeros((1, *INPUT_HW, 3)), False,
                                 seed=11)
    sd = _torch_sd(jpth.state_dict_from_variables(jm, variables))
    state = (_midas_dict(encoder, sd) if midas
             else {f"module.{k}": v for k, v in sd.items()})
    path = str(tmp_path / f"{name}.pth")
    torch.save(state, path)

    model = load_any_checkpoint(path, device="cpu")
    assert not model.training
    if midas:
        assert model.output_size == MIDAS_SIZES["output_size"]
        assert model.input_size == INPUT_HW
    ref_model, ref_vars = jpth.import_pth(path, example_input_hw=INPUT_HW)
    x = np.random.default_rng(4).standard_normal(
        (2, *INPUT_HW, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(ref_model.apply)(ref_vars, jnp.asarray(x)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------------------------
# tests/test_import_fuzz.py's cases, replayed against the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rn18_hu():
    model = randomize_(build_model("resnet18", "hu2018"), 0).eval()
    return model, pth_import.reference_state_dict(model)


def _import(state, tmp_path):
    path = tmp_path / "RN18-HU.pth"
    torch.save(state, path)
    return pth_import.import_pth(str(path))


def test_double_module_prefix_loads_clean(rn18_hu, tmp_path):
    model, sd = rn18_hu
    _state_equal(_import({f"module.module.{k}": v for k, v in sd.items()},
                         tmp_path), model)


def test_mixed_module_prefix_loads_clean(rn18_hu, tmp_path):
    # half the keys wrapped, half not: seen when checkpoints are merged
    model, sd = rn18_hu
    mangled = {(f"module.{k}" if i % 2 else k): sd[k]
               for i, k in enumerate(sorted(sd))}
    _state_equal(_import(mangled, tmp_path), model)


def test_extra_keys_raise_not_silently_ignored(rn18_hu, tmp_path):
    _, sd = rn18_hu
    with pytest.raises(KeyError, match="Unused torch keys.*stowaway"):
        _import(dict(sd, **{"E.stowaway.weight": torch.zeros(3, 3)}),
                tmp_path)


def test_num_batches_tracked_is_expected_and_ignored(rn18_hu, tmp_path):
    model, sd = rn18_hu
    bn_key = next(k for k in sd if k.endswith("running_mean"))
    state = dict(sd, **{bn_key.replace("running_mean",
                                       "num_batches_tracked"):
                        torch.tensor(42)})
    _state_equal(_import(state, tmp_path), model)


def test_missing_key_raises_with_expected_name(rn18_hu, tmp_path):
    _, sd = rn18_hu
    truncated = dict(sd)
    victim = next(k for k in sorted(truncated) if k.startswith("R."))
    del truncated[victim]
    with pytest.raises(KeyError, match=victim.replace(".", r"\.")):
        _import(truncated, tmp_path)


def test_shape_mismatch_raises_value_error(rn18_hu, tmp_path):
    _, sd = rn18_hu
    key = next(k for k in sorted(sd)
               if k.endswith(".weight") and sd[k].ndim == 4)
    with pytest.raises(ValueError, match="Shape mismatch"):
        _import(dict(sd, **{key: torch.zeros(1, 2, 3, 4)}), tmp_path)


def test_corrupt_file_raises_cleanly(tmp_path):
    path = tmp_path / "RN18-HU.pth"
    path.write_bytes(b"\x00\x01garbage" * 100)
    with pytest.raises(Exception) as err:
        load_any_checkpoint(str(path), device="cpu")
    assert not isinstance(err.value, (SystemExit, MemoryError))


def test_mixed_senet_key_vintages_load_identically():
    """Old ('se_fc1') and new ('se_module.fc1') SENet key styles, mixed per
    layer, fix to the same keys and values as in JAX (reside_model.py:
    42-43), on JAX's SN154-HU keys."""
    jm = jax_build_model("senet154", "hu2018")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *INPUT_HW, 3))))
    canonical = jpth.state_dict_from_variables(jm, _numbered_tree(shapes))
    assert any("se_module.fc1" in k for k in canonical)
    old = {k.replace("se_module.", "se_"): v for k, v in canonical.items()}
    mixed = {(k.replace("se_module.", "se_") if "se_module." in k
              and i % 2 == 0 else k): v
             for i, (k, v) in enumerate(sorted(canonical.items()))}
    fixed = [pth_import._fix_keys(s, senet=True)
             for s in (canonical, old, mixed)]
    for state, ours in zip((canonical, old, mixed), fixed):
        assert ours.keys() == jpth._fix_keys(state, senet=True).keys()
        assert ours.keys() == canonical.keys()
        assert all(ours[k] is canonical[k] for k in canonical)


# ---------------------------------------------------------------------------
# the port's own writer, and the MidasNet dict's version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder,decoder", [
    ("efficientnet-b0", "hu2018"), ("resnet18", "lasinger2019")])
def test_reference_state_dict_round_trips(encoder, decoder, tmp_path):
    """``reference_state_dict`` → ``torch.save`` → ``import_pth`` gives the
    model back bit for bit; also into a model passed in, and through
    ``load_any_checkpoint``."""
    midas = decoder == "lasinger2019"
    model = randomize_(build_model(encoder, decoder,
                                   **(MIDAS_SIZES if midas else {})), 5)
    sd = pth_import.reference_state_dict(model)
    assert all(v.device.type == "cpu" for v in sd.values())
    path = str(tmp_path / "model.pth")
    torch.save(_midas_dict(encoder, sd) if midas else sd, path)
    if midas:
        _state_equal(pth_import.import_pth(path), model)
    target = build_model(encoder, decoder, **(MIDAS_SIZES if midas else {}))
    _state_equal(pth_import.import_pth(path, model=target), model)
    _state_equal(load_any_checkpoint(path, build_model(
        encoder, decoder, **(MIDAS_SIZES if midas else {})), device="cpu"),
        model)


def test_version_mismatch_warns(tmp_path):
    model = randomize_(build_model("resnet18", "lasinger2019", **MIDAS_SIZES),
                       6)
    path = str(tmp_path / "old.pth")
    torch.save(_midas_dict("resnet18", pth_import.reference_state_dict(model),
                           version="0.1.0"), path)
    with pytest.warns(UserWarning, match="Version mismatch: checkpoint "
                                         "0.1.0 vs 0.2.0"):
        loaded = pth_import.import_pth(path)
    _state_equal(loaded, model)
    with pytest.warns(UserWarning, match="Version mismatch"):
        jpth.import_pth(path, example_input_hw=INPUT_HW)


def test_ede_loads_into_a_model_passed_in():
    """``load_any_checkpoint(path, model)`` of an ``.ede`` puts the file's
    weights into ``model``, as JAX returns its variables for the model
    passed in."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "e2e", "ENB0-LR-synthetic.ede")
    ref = load_any_checkpoint(path, device="cpu")
    target = build_model("efficientnet-b0", "lasinger2019")
    loaded = load_any_checkpoint(path, target, device="cpu")
    assert loaded is target and not loaded.training
    _state_equal(loaded, ref)
