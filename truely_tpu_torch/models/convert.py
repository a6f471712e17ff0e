"""Convert public facenet-pytorch checkpoints into the ``.npz`` weight files
that both packages read through ``$TRUELY_TPU_WEIGHTS``.

    python -m truely_tpu_torch.models.convert \\
        --pnet pnet.pt --rnet rnet.pt --onet onet.pt \\
        --facenet 20180402-114759-vggface2.pt --out weights/

Sources (facenet-pytorch package data and release downloads): the MTCNN
stage nets ``pnet.pt``, ``rnet.pt``, ``onet.pt`` and the vggface2
InceptionResnetV1, each a state dict (the training-only ``logits.*``
classifier keys are dropped).  Each goes through
``models.weights.convert_torch_state_dict`` and is written by
``models.weights.save_params``.  Then: ``export TRUELY_TPU_WEIGHTS=weights/``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from truely_tpu_torch.models.weights import convert_torch_state_dict, save_params


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict without the ``logits.*`` classifier."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if not k.startswith("logits.")}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m truely_tpu_torch.models.convert",
                                 description=__doc__.splitlines()[0])
    for name in ("pnet", "rnet", "onet", "facenet"):
        ap.add_argument(f"--{name}", metavar="CKPT", help=f"{name} state dict (.pt)")
    ap.add_argument("--out", required=True, help="directory of the .npz files")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in ("pnet", "rnet", "onet", "facenet"):
        path = getattr(args, name)
        if not path:
            print(f"[skip] {name}: no checkpoint given")
            continue
        out_path = os.path.join(args.out, f"{name}.npz")
        save_params(out_path, convert_torch_state_dict(name, load_state_dict(path)))
        print(f"[ok] {name}: {path} -> {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
