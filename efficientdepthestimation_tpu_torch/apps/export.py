"""Export a serving artifact: the whole serving pipeline in one file.

Counterpart of ``efficientdepthestimation_tpu/apps/export.py``. The
reference serves by shipping its source tree and a ``.pth``; this writes
one ``torch.export`` artifact of the 640×480 serving pipeline (uint8 frames
→ preprocess → forward → upsample), which
``checkpoints.export.load_serving_artifact`` serves with ``torch`` and the
kernels' op registrations alone.

    python -m efficientdepthestimation_tpu_torch.apps.export \\
        --model e2e/ENB0-HU-synthetic.ede --out enb0_hu.edz --batch 128 \\
        --verify

``--device`` (the card by default, ``cpu`` on request) is where the
program is traced and its tensors live, so where it is served.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from efficientdepthestimation_tpu_torch.apps.common import (
    infer_arch_from_path,
    load_any_checkpoint,
    resolve_device,
)

__all__ = ["main"]


def _architecture(path: str) -> tuple[str, str]:
    """(encoder, decoder) of a checkpoint: from its name
    (``infer_arch_from_path``), else from its ``.ede`` header."""
    try:
        return infer_arch_from_path(path)
    except ValueError:
        from efficientdepthestimation_tpu_torch.checkpoints.serialization import (  # noqa: E501
            MAGIC,
            read_ede,
        )

        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise
        header, _ = read_ede(path)
        if header.get("format") == "midas-self-describing":
            return header["encoder"]["name"], "lasinger2019"
        return header["encoder"], header["decoder"]


def main(args: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="Export an ahead-of-time serving artifact")
    parser.add_argument("--model", type=str, default=None,
                        help="checkpoint (.pth or .ede); the architecture "
                             "is read from its name, or from an .ede's "
                             "header where the name does not give it")
    parser.add_argument("--encoder", type=str, default="efficientnet-b0",
                        help="used (with a random init) when --model is "
                             "absent")
    parser.add_argument("--decoder", type=str, default="hu2018")
    parser.add_argument("--out", required=True, type=str)
    parser.add_argument("--batch", type=str, default="128",
                        help="static batch size, or 'dynamic' for a "
                             "symbolic batch")
    parser.add_argument("--in-hw", type=int, nargs=2, default=(480, 640))
    parser.add_argument("--crop-hw", type=int, nargs=2, default=(228, 304))
    parser.add_argument("--out-hw", type=int, nargs=2, default=(480, 640))
    parser.add_argument("--f32", action="store_true",
                        help="keep float32 weights and activations "
                             "(default bf16)")
    parser.add_argument("--no-bake", action="store_true",
                        help="weights as an input of the program "
                             "(swappable) instead of folded constants")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device the program is traced and served "
                             "on (default: the CUDA card; 'cpu' on request)")
    parser.add_argument("--verify", action="store_true",
                        help="reload the artifact and check it against the "
                             "live pipeline on random frames")
    raw_args = list(args) if args is not None else sys.argv[1:]
    ns = parser.parse_args(raw_args)

    from efficientdepthestimation_tpu_torch.apps.common import _serving_copy
    from efficientdepthestimation_tpu_torch.checkpoints.export import (
        load_serving_artifact,
        pipeline,
        save_serving_artifact,
    )
    from efficientdepthestimation_tpu_torch.models.registry import (
        build_model,
    )

    device = resolve_device(ns.device)
    if ns.model is not None:
        encoder, decoder = _architecture(ns.model)
        explicit = {a for a in ("--encoder", "--decoder")
                    if any(s == a or s.startswith(a + "=") for s in raw_args)}
        if explicit:
            print(f"warning: {sorted(explicit)} ignored — architecture "
                  f"{encoder}-{decoder} inferred from --model filename")
        model = load_any_checkpoint(ns.model, device="cpu")
    else:
        encoder, decoder = ns.encoder, ns.decoder
        model = build_model(encoder, decoder).eval()

    batch = None if ns.batch == "dynamic" else int(ns.batch)
    dtype = None if ns.f32 else torch.bfloat16
    hw = dict(in_hw=tuple(ns.in_hw), crop_hw=tuple(ns.crop_hw),
              out_hw=tuple(ns.out_hw))
    meta = save_serving_artifact(
        ns.out, model, encoder=encoder, decoder=decoder, batch=batch,
        dtype=dtype, bake_weights=not ns.no_bake, device=device, **hw)
    print(f"Wrote {ns.out}: {meta}")

    if ns.verify:
        fn, _ = load_serving_artifact(ns.out)
        rng = np.random.default_rng(0)
        b = batch if batch is not None else 2
        frames = torch.from_numpy(rng.integers(
            0, 256, (b, *ns.in_hw, 3), dtype=np.uint8)).to(device)
        got = fn(frames)
        live = pipeline(_serving_copy(model, device, dtype, not ns.no_bake),
                        hw["crop_hw"], hw["out_hw"], dtype)
        with torch.inference_mode():
            want = live(frames)
        err = float((got - want).abs().max())
        # The JAX package's tolerances: 1 ulp of bf16 at metre-scale depths
        # is ~0.03, so bf16 is held to 1e-2, f32 to 1e-5.
        tol = 1e-5 if ns.f32 else 1e-2
        print(f"verify: max abs diff vs the live pipeline = {err:.3e} "
              f"(tol {tol:g})")
        if not err < tol:
            raise ValueError(
                f"artifact verify failed: max abs diff {err:.3e} >= {tol:g} "
                f"({'f32' if ns.f32 else 'bf16'} export, batch={b}, "
                f"in_hw={tuple(ns.in_hw)})")
        meta["verify_max_abs_diff"] = err
    return meta


if __name__ == "__main__":
    main()
