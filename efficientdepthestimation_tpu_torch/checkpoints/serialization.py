"""The JAX package's native ``.ede`` checkpoints, read and written on msgpack
alone.

Layout (``efficientdepthestimation_tpu/checkpoints/serialization.py``):
``b"EDE1"``, an 8-byte little-endian header length, a JSON header, then the
flax variable tree as msgpack in which each array is extension type 1
holding msgpack ``(shape, dtype name, raw C-order bytes)`` (a numpy scalar:
type 3, the same payload), as ``flax.serialization.msgpack_serialize``
writes it. A file either package writes loads in the other.

Four formats:

- ``hu2018-state`` (header ``encoder``, ``decoder``): a Hu2018 model's
  ``params`` and ``batch_stats`` (``save_checkpoint``);
- ``midas-self-describing``, the reference's MidasNet schema
  (``encoder.name``/``freeze_weights``, ``decoder.num_features``/
  ``non_negative``, ``input_size``/``output_size`` in **WH** order, which the
  model takes as HW, ``adversarial_training``, ``version``; ``save_midas``);
- ``train-state``: the model, the optimizer in optax's state-dict layout and
  the step, for an exact resume in either package (``save_train_state``);
- ``discriminator``: ``models.midas.Discriminator`` (``save_discriminator``).
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from efficientdepthestimation_tpu_torch import MIDAS_CHECKPOINT_VERSION
from efficientdepthestimation_tpu_torch.checkpoints.convert import (
    from_jax_variables,
    pack_tree,
    to_jax_variables,
    unpack_tree,
)
from efficientdepthestimation_tpu_torch.models.midas import (
    Discriminator,
    MidasNet,
)
from efficientdepthestimation_tpu_torch.models.registry import build_model
from efficientdepthestimation_tpu_torch.parallel.mesh import (
    all_reduce_,
    broadcast_flat,
)

__all__ = ["read_ede", "write_ede", "load_checkpoint", "save_checkpoint",
           "load_midas", "save_midas", "check_midas_version", "midas_model",
           "save_train_state", "load_train_state", "save_discriminator",
           "load_discriminator", "MAGIC"]

MAGIC = b"EDE1"
def read_ede(path: str) -> tuple[dict, dict]:
    """(header, variable tree of numpy arrays) of an ``.ede`` file."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"Not an EDE checkpoint (magic {magic!r})")
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        tree = unpack_tree(f.read())
    return header, tree


def write_ede(path: str, header: dict, tree: dict) -> None:
    """Write ``header`` and a nested dict of numpy arrays as an ``.ede``
    file (the JAX package's ``_write``). The file appears whole or not at
    all: it is written beside its name and renamed over it."""
    payload = pack_tree(tree)
    header_bytes = json.dumps(header).encode()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header_bytes).to_bytes(8, "little"))
        f.write(header_bytes)
        f.write(payload)
    os.replace(tmp, path)


def check_midas_version(header: dict) -> None:
    """Warn when a self-describing MidasNet's schema version is not the
    reference's (lasinger2019.py:396-400)."""
    if header.get("version") != MIDAS_CHECKPOINT_VERSION:
        warnings.warn(f"Version mismatch: checkpoint {header.get('version')} "
                      f"vs {MIDAS_CHECKPOINT_VERSION}.")


def midas_model(header: dict) -> nn.Module:
    """The MidasNet a self-describing header (an ``.ede`` header, or the
    reference's ``.pth`` dict) describes, sizes WH → HW."""
    w_in, h_in = header.get("input_size") or header["output_size"]
    w_out, h_out = header["output_size"]
    decoder = header["decoder"]
    return build_model(header["encoder"]["name"], "lasinger2019",
                       output_size=(h_out, w_out), input_size=(h_in, w_in),
                       num_features=decoder.get("num_features", "auto"),
                       non_negative=decoder.get("non_negative", False))


def _model_of(header: dict) -> nn.Module:
    if header.get("format") == "midas-self-describing":
        check_midas_version(header)
        return midas_model(header)
    return build_model(header["encoder"], header.get("decoder", "hu2018"))


def load_checkpoint(path: str) -> tuple[nn.Module, dict]:
    """(model with the checkpoint's weights, on the CPU, eval; header) of a
    model file (``hu2018-state``, ``midas-self-describing``) or of a
    ``train-state`` file's model."""
    header, tree = read_ede(path)
    fmt = header.get("format")
    if fmt not in ("midas-self-describing", "hu2018-state", "train-state"):
        raise ValueError(f".ede format {fmt!r} holds no depth model")
    model = _model_of(header)
    model.load_state_dict(from_jax_variables(tree), strict=True)
    return model, header


def save_checkpoint(path: str, model: nn.Module, *, encoder: str,
                    decoder: str, extra: dict | None = None) -> None:
    """A model's weights and statistics with an architecture header
    (``hu2018-state``, the JAX package's Hu-style checkpoint)."""
    header = {"format": "hu2018-state", "encoder": encoder,
              "decoder": decoder, "version": MIDAS_CHECKPOINT_VERSION,
              **(extra or {})}
    write_ede(path, header, to_jax_variables(model.state_dict()))


def _encoder_name(model: nn.Module) -> str:
    """The registry name of a model's encoder (its ``variant``), as the JAX
    package's ``_encoder_name`` reads it from the encoder factory."""
    return (model.encoder if isinstance(model, MidasNet) else model.E).variant


def save_midas(path: str, model: MidasNet) -> None:
    """A MidasNet with the reference's self-describing schema, sizes WH
    (lasinger2019.py:372-415)."""
    h_out, w_out = model.output_size
    h_in, w_in = model.input_size or model.output_size
    header = {
        "format": "midas-self-describing",
        "encoder": {"name": _encoder_name(model), "freeze_weights": False},
        "decoder": {"num_features": int(model.decoder.feature_count),
                    "non_negative": bool(model.decoder.non_negative)},
        "input_size": (w_in, h_in),
        "output_size": (w_out, h_out),
        "adversarial_training": False,
        "version": MIDAS_CHECKPOINT_VERSION,
    }
    write_ede(path, header, to_jax_variables(model.state_dict()))


def load_midas(path: str) -> tuple[nn.Module, dict]:
    """``load_checkpoint`` of a MidasNet checkpoint; ValueError otherwise."""
    model, header = load_checkpoint(path)
    if header.get("format") != "midas-self-describing":
        raise ValueError("Not a MidasNet checkpoint")
    return model, header


# --- the train state, in optax's state-dict layout -------------------------
#
# ``adam_with_l2`` is ``optax.chain(add_decayed_weights, adam(lr))``, whose
# state is ``{"0": {}, "1": {"0": {count, mu, nu}, "1": <lr>}}``: <lr> is
# ``{"count"}`` for a schedule, ``{}`` for a constant. With frozen top-level
# keys it is wrapped as ``{"inner_states": {"frozen": {"inner_state": {}},
# "trained": {"inner_state": <that>}}}``, and ``mu``/``nu`` hold ``{}`` under
# each frozen key. ``mu``/``nu`` are torch Adam's ``exp_avg``/``exp_avg_sq``
# with the parameters' layout; ``count`` is the number of updates, which is
# Adam's ``step`` and the LR schedule's count. Under ZeRO-1 each rank's
# optimizer holds only the parameters it owns (``TrainState.owners``): a
# save gathers every owner's moments first, and a load keeps each rank's.


def _adam_states(state) -> tuple[int, dict]:
    """(count, {trained name: Adam's state}) of the whole model, on every
    rank. Under ZeRO-1 over several ranks each owner broadcasts its
    parameters' moments (every rank takes part). Before the first update
    there are no moments, and the count is 0; after it, a trained parameter
    without moments raises rather than being written as zeros."""
    named = state.trained()
    mesh = state.mesh
    local = {k: state.optimizer.state[p] for k, p in named
             if p in state.optimizer.state}
    count = max((int(a["step"]) for a in local.values()), default=0)
    owned = [k for k, _ in named
             if state.owners is None or state.owners[k] == mesh.data_index]
    missing = sum(k not in local for k in owned)
    if mesh is not None and mesh.distributed:
        device = next(state.model.parameters()).device
        flags = all_reduce_(torch.tensor([count, missing], dtype=torch.int64,
                                         device=device), mesh,
                            dist.ReduceOp.MAX)
        count, missing = (int(v) for v in flags.cpu())
    if count and missing:
        raise RuntimeError(f"train-state: {missing} trained parameters have "
                           "no Adam moments after an update")
    if not count:
        return 0, {}
    if state.owners is None or not mesh.distributed:
        return count, local
    gathered = {}
    for owner in range(mesh.shape["data"]):
        mine = [(k, p) for k, p in named if state.owners[k] == owner]
        for k, p in mine:
            gathered[k] = local.get(k) or {"exp_avg": torch.empty_like(p),
                                           "exp_avg_sq": torch.empty_like(p)}
        with torch.no_grad():
            broadcast_flat([gathered[k][key] for k, _ in mine
                            for key in ("exp_avg", "exp_avg_sq")], owner, mesh)
    return count, gathered


def _opt_state_dict(state) -> dict:
    count, adams = _adam_states(state)
    moments = {"mu": {}, "nu": {}}
    for name, p in state.trained():
        for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[key][name] = (adams[name][torch_key] if count
                                  else torch.zeros_like(p))
    count_arr = np.asarray(count, np.int32)
    adam = {"count": count_arr}
    for key, values in moments.items():
        tree = to_jax_variables(values).get("params", {})
        for top in state.frozen_prefixes:
            tree[top] = {}
        adam[key] = tree
    chain = {"0": {}, "1": {"0": adam,
                            "1": {"count": count_arr} if state.scheduled
                            else {}}}
    if not state.frozen_prefixes:
        return chain
    return {"inner_states": {"frozen": {"inner_state": {}},
                             "trained": {"inner_state": chain}}}


def _load_opt_state(state, opt: dict) -> None:
    frozen = "inner_states" in opt
    if frozen != bool(state.frozen_prefixes):
        raise ValueError("train-state: the checkpoint's optimizer was built "
                         f"{'with' if frozen else 'without'} frozen keys, "
                         "this one the other way")
    chain = opt["inner_states"]["trained"]["inner_state"] if frozen else opt
    adam = chain["1"]["0"]
    count = int(adam["count"])
    mu = from_jax_variables({"params": adam["mu"]})
    nu = from_jax_variables({"params": adam["nu"]})
    params = dict(state.model.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    if set(mu) != trained or set(nu) != trained:
        raise ValueError("train-state: the optimizer's moments are not "
                         "those of this model's trained parameters")
    state.optimizer.state.clear()
    for name in trained:
        if (state.owners is not None
                and state.owners[name] != state.mesh.data_index):
            continue  # ZeRO-1: another rank's moments
        p = params[name]
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    state.set_count(count)


def save_train_state(path: str, state, *, encoder: str, decoder: str,
                     epoch: int, step_in_epoch: int | None = None) -> None:
    """The whole training state (weights, BN statistics, Adam's moments and
    count, the step) for an exact resume, in either package.

    ``step_in_epoch`` is set for a mid-epoch save (``--save-every``, a
    preemption): the batches of ``epoch`` already applied, which a resume
    skips. ``None`` means that the epoch ended, and a resume starts the
    next one.

    Under a data-parallel mesh every rank calls it (a ZeRO-1 state gathers
    its moments from their owners) and rank 0 alone writes the file."""
    opt_state = _opt_state_dict(state)
    if state.mesh is not None and state.mesh.rank != 0:
        return
    header = {"format": "train-state", "encoder": encoder,
              "decoder": decoder, "epoch": int(epoch),
              "step": int(state.step), "version": MIDAS_CHECKPOINT_VERSION}
    if step_in_epoch is not None:
        header["step_in_epoch"] = int(step_in_epoch)
    payload = to_jax_variables(state.model.state_dict())
    payload.setdefault("batch_stats", {})
    payload["opt_state"] = opt_state
    write_ede(path, header, payload)


def load_train_state(path: str, state):
    """Restore a ``train-state`` file into a ``TrainState`` built for the
    same model and optimizer (``create_train_state``), in place: weights,
    statistics, Adam's moments, the update count (and so the LR schedule)
    and the step. Returns ``(state, header)``. Under a mesh every rank
    reads the file; a ZeRO-1 rank keeps the moments it owns, whatever the
    world size of the run that wrote it."""
    header, payload = read_ede(path)
    if header.get("format") != "train-state":
        raise ValueError("Not a train-state checkpoint")
    device = next(state.model.parameters()).device
    weights = from_jax_variables(payload)
    state.model.load_state_dict({k: v.to(device) for k, v in weights.items()},
                                strict=True)
    _load_opt_state(state, payload["opt_state"])
    state.step = int(header["step"])
    return state, header


def save_discriminator(path: str, model: Discriminator) -> None:
    """The Discriminator's schema {'weights', 'options', 'version'}
    (lasinger2019.py:457-472)."""
    header = {"format": "discriminator",
              "options": {"in_channels": int(model.in_channels),
                          "adversarial_training":
                              bool(model.adversarial_training)},
              "version": MIDAS_CHECKPOINT_VERSION}
    write_ede(path, header, to_jax_variables(model.state_dict()))


def load_discriminator(path: str) -> tuple[Discriminator, dict]:
    """(Discriminator with the file's weights, on the CPU, eval; header)."""
    header, tree = read_ede(path)
    if header.get("format") != "discriminator":
        raise ValueError("Not a Discriminator checkpoint")
    check_midas_version(header)
    model = Discriminator(**header["options"])
    model.load_state_dict(from_jax_variables(tree), strict=True)
    return model.eval(), header
