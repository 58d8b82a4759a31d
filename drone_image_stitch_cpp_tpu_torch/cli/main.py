"""Command-line interface of the PyTorch port.

The JAX CLI's flags that the ported path uses (folder, type, group,
output root, ``--no-save-strips``, ``--resume``, JSONL log,
``--trace-dir``, every StitchTuning knob by its field name, e.g.
``--global-sift-features``) plus ``--device`` (default ``cuda``: every
visible card; ``cuda:N`` one card; ``cuda`` without a visible card is an
error, never a silent CPU run). The camera calibration is not a flag, as
in the JAX CLI: pass it through ``RunConfig.tuning_overrides``.

    python -m drone_image_stitch_cpp_tpu_torch.cli.main --device cuda \\
        --image-folder IMAGES --image-type visible --group run \\
        --output-root OUT
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..config.tuning import StitchTuning


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def _knob_fields():
    """The StitchTuning fields that are flags (all but the calibration)."""
    return [f for f in dataclasses.fields(StitchTuning)
            if f.name != "calibration"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-mosaic-torch",
        description="Drone ortho-mosaicking on PyTorch + CUDA")
    p.add_argument("--image-folder", default="../images",
                   help="root folder; images at <root>/<type>/<group>")
    p.add_argument("--image-type", default="visible",
                   help="modality preset alias (visible/nir/lwir/...)")
    p.add_argument("--group", default="minfull")
    p.add_argument("--output-root", default="../output")
    p.add_argument("--no-save-strips", action="store_true",
                   help="skip the per-strip JPEGs (the checkpoint is "
                        "still written)")
    p.add_argument("--resume", action="store_true",
                   help="resume the global stage from the strip checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (every visible card), cuda:N (one) or cpu")
    p.add_argument("--log-jsonl", default=None,
                   help="structured log sink (JSONL)")
    p.add_argument("--trace-dir", default=None,
                   help="torch.profiler Chrome trace output directory")
    defaults = StitchTuning()
    for f in _knob_fields():
        flag = "--" + f.name.replace("_", "-")
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(flag, type=_str2bool, default=None,
                           metavar="BOOL")
        elif isinstance(default, int):
            p.add_argument(flag, type=int, default=None)
        else:
            p.add_argument(flag, type=float, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..app import RunConfig, run_stitch_application
    from ..runtime.logging import device_trace, get_logger

    overrides = {f.name: getattr(args, f.name) for f in _knob_fields()
                 if getattr(args, f.name) is not None}
    if args.log_jsonl:
        get_logger().jsonl_path = args.log_jsonl
    cfg = RunConfig(image_folder=args.image_folder,
                    image_type=args.image_type, group=args.group,
                    output_root=args.output_root, device=args.device,
                    save_strips=not args.no_save_strips, resume=args.resume,
                    tuning_overrides=overrides)
    with device_trace(args.trace_dir):
        return run_stitch_application(cfg)


if __name__ == "__main__":
    sys.exit(main())
