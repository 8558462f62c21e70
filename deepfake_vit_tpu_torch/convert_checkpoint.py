"""Convert torch checkpoints of the reference's layouts to framework files.

    python -m deepfake_vit_tpu_torch.convert_checkpoint --input IN --output OUT
        [--kind backbone|model|vit|detector] [--variant V] [--hidden-dims D ...]

The flags and the four kinds of the JAX package's
``scripts/convert_checkpoint.py``, writing the same trees, so that either
package reads what the other converts:

- ``backbone``: an efficientnet-pytorch ImageNet ``.pth`` → a checkpoint
  whose ``params``/``batch_stats`` hold ``{"backbone": ...}``;
- ``model``: a reference ``DeepfakeDetectionModel`` ``.pth`` → a
  checkpoint that ``evaluate``, ``predict`` and ``FusedPipeline`` load;
- ``vit``: a HuggingFace ``ViTForImageClassification`` state-dict file
  (``.pth``) or model directory → ``ViTClassifier`` params (``--variant``
  tiny16, small16 or base16; any other value means base16, as in JAX). A
  directory needs the ``transformers`` package, imported only then;
- ``detector``: an SCRFD-style ``.pth`` → a flax msgpack of
  ``ScrfdDetector`` variables (``FaceDetector.load_weights`` reads it).

Checkpoints are written with ``utils/io_utils.save_checkpoint`` (epoch 0,
empty ``opt_state``, ``source``), the detector with the msgpack writer.
Input ``.pth`` files are unpickled in full: convert only files you trust.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

VIT_VARIANTS = ("tiny16", "small16", "base16")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="torch → framework checkpoint conversion")
    parser.add_argument("--input", type=str, required=True, help=".pth / HF dir")
    parser.add_argument("--output", type=str, required=True, help="output .ckpt path")
    parser.add_argument("--kind", choices=["backbone", "model", "vit", "detector"],
                        default="model")
    parser.add_argument("--variant", type=str, default="b4")
    parser.add_argument("--hidden-dims", type=int, nargs="+", default=[512, 128, 32])
    args = parser.parse_args(argv)

    from .models.convert import (convert_detection_model, convert_efficientnet_backbone,
                                 convert_scrfd_detector, load_torch_state_dict)
    from .utils.io_utils import save_checkpoint
    from .utils.logger import setup_logger
    from .utils.msgpack import msgpack_serialize

    logger = setup_logger("convert")
    out = Path(args.output)
    source = str(args.input)
    if args.kind == "detector":
        variables = convert_scrfd_detector(load_torch_state_dict(args.input))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(msgpack_serialize(variables))
        logger.info(f"converted detector checkpoint → {out}")
        return 0
    if args.kind == "vit":
        from .models.vit import convert_hf_vit

        if Path(args.input).is_dir():
            import transformers

            sd = transformers.ViTForImageClassification.from_pretrained(args.input).state_dict()
        else:
            sd = load_torch_state_dict(args.input)
        variant = args.variant if args.variant in VIT_VARIANTS else "base16"
        state = {"epoch": 0, "params": convert_hf_vit(sd, variant)["params"], "batch_stats": {},
                 "opt_state": {}, "source": source}
    elif args.kind == "backbone":
        params, stats = convert_efficientnet_backbone(load_torch_state_dict(args.input),
                                                      args.variant)
        state = {"epoch": 0, "params": {"backbone": params}, "batch_stats": {"backbone": stats},
                 "opt_state": {}, "source": source}
    else:
        variables = convert_detection_model(load_torch_state_dict(args.input), args.variant,
                                            tuple(args.hidden_dims))
        state = {"epoch": 0, "params": variables["params"],
                 "batch_stats": variables["batch_stats"], "opt_state": {}, "source": source}
    path = save_checkpoint(state, out.parent, filename=out.name, max_keep=0)
    logger.info(f"converted {args.kind} checkpoint → {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
