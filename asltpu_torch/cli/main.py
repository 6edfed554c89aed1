"""CLI: ``predict`` and ``serve``, the entry points to the port's inference
and its server. Counterpart of those two subcommands of
``asltpu/cli/main.py``.

Usage:
  python -m asltpu_torch.cli predict CLIP.mp4 [--model mobilenet_gru] [--ckpt PATH]
  python -m asltpu_torch.cli predict SESSION.mp4 --windows 2.0 [--window-stride 1.0]
  python -m asltpu_torch.cli serve --model mobilenet_gru --batch-buckets 1,4,8

Every subcommand takes ``--device`` (the card by default; ``cpu`` runs on
the host).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from typing import List, Optional

from asltpu_torch.utils.logging import get_logger

log = get_logger("asltpu_torch.cli")


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="mobilenet_gru",
                   help="config name (pose_bilstm | mobilenet_gru | "
                        "resnet_transformer | i3d | two_stream)")
    p.add_argument("--ckpt", default=None,
                   help="a torch .pt/.pth checkpoint or a training checkpoint "
                        "directory of this package")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides",
                   help="config field override, repeatable — e.g. "
                        "--set gru_hidden=256 --set preprocess.num_frames=8 "
                        "(values parsed as Python literals, else strings)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on "
                        "the host)")


def _parse_overrides(pairs):
    """['gru_hidden=256', 'preprocess.crop=96'] → config override kwargs
    (``preprocess.`` keys become the preprocess dict)."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"error: --set expects KEY=VALUE, got '{pair}'")
        key, raw = pair.split("=", 1)
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        if key.startswith("preprocess."):
            out.setdefault("preprocess", {})[key[len("preprocess."):]] = val
        else:
            out[key] = val
    return out


def _model_overrides(args):
    overrides = _parse_overrides(args.overrides)
    if args.num_classes:
        overrides["num_classes"] = args.num_classes
    return overrides


def _load(args):
    from asltpu_torch.api import load_model
    from asltpu_torch.config import CONFIG_REGISTRY

    if args.model not in CONFIG_REGISTRY:
        raise SystemExit(
            f"error: unknown model '{args.model}'; choose from "
            f"{', '.join(sorted(CONFIG_REGISTRY))}"
        )
    return load_model(args.model, checkpoint=args.ckpt, device=args.device,
                      **_model_overrides(args))


def _gloss_names(args, model):
    from asltpu_torch.data.wlasl import WLASLIndex

    if not args.index:
        return None
    return WLASLIndex(args.index, getattr(args, "videos", None) or "",
                      subset=model.cfg.num_classes).glosses


def cmd_predict(args) -> int:
    from asltpu_torch import api

    # Inputs are checked before the model loads.
    missing = [c for c in args.clips if not os.path.exists(c)]
    if missing:
        raise SystemExit(f"error: clip(s) not found: {', '.join(missing)}")
    # The codec-level fast modes live in the libav backend only, so
    # --decode-fast implies av and contradicts any other backend.
    if args.decode_fast:
        if args.decode_backend == "auto":
            args.decode_backend = "av"
        elif args.decode_backend != "av":
            raise SystemExit("error: --decode-fast requires --decode-backend av")
    if args.decode_backend == "av":
        from asltpu_torch import native

        if not native.av_available():
            raise SystemExit(
                "error: --decode-backend av unavailable: "
                f"{native.av_unavailable_reason()}"
            )
    if args.windows is not None and args.windows <= 0:
        raise SystemExit("error: --windows expects a positive duration")
    if args.windows is not None and args.model == "pose_bilstm":
        raise SystemExit(
            "error: --windows takes video; pose_bilstm windows a landmark "
            "stream instead — use asltpu_torch.windows.predict_windows_landmarks "
            "or POST /predict_windows_landmarks on the server"
        )
    if args.windows is not None and args.model == "two_stream":
        if not args.landmarks_stream:
            raise SystemExit(
                "error: --windows with the fusion model needs "
                "--landmarks-stream FILE.npy ([T, 543, 3] aligned to the "
                "video's frames)"
            )
        if len(args.clips) != 1:
            raise SystemExit(
                "error: --landmarks-stream aligns to ONE video; pass "
                "exactly one clip"
            )
    model = _load(args)
    if args.windows is not None:
        return _predict_windows(args, model)
    landmarks_for = None
    if model.takes_landmarks:
        if not args.landmarks_dir:
            raise SystemExit(
                f"error: model '{args.model}' consumes landmarks; pass "
                "--landmarks-dir with precomputed <video_id>.npy files"
            )
        from asltpu_torch.data.landmarks import LandmarkStore

        nf = getattr(model.cfg, "num_frames", 16)
        landmarks_for = LandmarkStore(args.landmarks_dir).for_path(nf)
    gloss_names = _gloss_names(args, model)
    for path, gloss, logits in api.stream_predict(
        model, args.clips, batch_size=args.batch, gloss_names=gloss_names,
        landmarks_for=landmarks_for, skip_errors=args.skip_errors,
        decode_backend=args.decode_backend, decode_fast=args.decode_fast,
    ):
        print(json.dumps({"clip": path, "gloss": gloss, "top5": _top5(logits, gloss_names)}))
    return 0


def _predict_windows(args, model) -> int:
    """``predict --windows S clip...``: continuous recognition, one JSON
    line per video with the merged gloss segments and the per-window
    trace (:mod:`asltpu_torch.windows`)."""
    import numpy as np

    from asltpu_torch.windows import merge_windows, predict_windows, segments_json, windows_json

    gloss_names = _gloss_names(args, model)
    landmark_stream = None
    if args.landmarks_stream:
        landmark_stream = np.load(args.landmarks_stream, allow_pickle=False)
    for path in args.clips:
        wins = predict_windows(
            model, path,
            window_seconds=args.windows,
            stride_seconds=args.window_stride,
            batch_size=args.batch,
            gloss_names=gloss_names,
            decode_backend=args.decode_backend,
            decode_fast=args.decode_fast,
            landmark_stream=landmark_stream,
        )
        print(json.dumps({
            "clip": path,
            "segments": segments_json(merge_windows(wins, min_prob=args.min_prob)),
            "windows": windows_json(wins),
        }))
    return 0


def _top5(logits, gloss_names):
    from asltpu_torch.eval.metrics import topk_entries

    return topk_entries(logits, gloss_names)


def cmd_serve(args) -> int:
    """Run the HTTP inference server (dynamic batching on one card)."""
    from asltpu_torch.serve_http import serve

    model = _load(args)
    buckets = (
        tuple(int(b) for b in args.batch_buckets.split(","))
        if args.batch_buckets else None
    )
    log.info("serving %s on %s:%d", args.model, args.host, args.port)
    serve(model, host=args.host, port=args.port, max_batch=args.max_batch,
          max_delay_ms=args.max_delay_ms, gloss_names=_gloss_names(args, model),
          batch_buckets=buckets, warm=buckets is not None)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m asltpu_torch.cli", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="predict gloss for clip(s)")
    p.add_argument("--decode-backend", default="auto",
                   choices=["auto", "native", "av", "process", "thread"],
                   help="decode pool backend; 'av' = direct libavcodec "
                        "(tolerance-parity with the cv2 path)")
    p.add_argument("--decode-fast", action="store_true",
                   help="codec-level work reduction (av backend only): "
                        "reduced-resolution decode + loop-filter/nonref "
                        "skip; approximate decode")
    _add_model_args(p)
    p.add_argument("clips", nargs="+")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--index", default=None, help="WLASL index json for gloss names")
    p.add_argument("--videos", default=None)
    p.add_argument("--landmarks-dir", default=None,
                   help="precomputed <video_id>.npy landmarks (pose/fusion)")
    p.add_argument("--skip-errors", action="store_true",
                   help="skip undecodable clips instead of failing")
    p.add_argument("--windows", type=float, default=None, metavar="SECONDS",
                   help="continuous recognition: classify sliding windows "
                        "of this duration over each video and print merged "
                        "gloss segments (RGB models; asltpu_torch.windows)")
    p.add_argument("--window-stride", type=float, default=None, metavar="SECONDS",
                   help="window hop (default: half the window — 50%% overlap)")
    p.add_argument("--min-prob", type=float, default=0.0,
                   help="windows whose top softmax probability falls below "
                        "this merge into 'uncertain' segments (gloss null) "
                        "instead of asserting a gloss")
    p.add_argument("--landmarks-stream", default=None, metavar="NPY",
                   help="with --windows on the fusion model: the session's "
                        "per-frame [T, 543, 3] landmarks aligned to the "
                        "(single) video's frames")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("serve", help="HTTP inference server")
    _add_model_args(p)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; the endpoint is unauthenticated, so "
                        "binding non-loopback (e.g. 0.0.0.0) is an explicit "
                        "opt-in")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-delay-ms", type=float, default=10.0)
    p.add_argument("--batch-buckets", default=None, metavar="B1,B2,...",
                   help="pad partial batches to the smallest listed size "
                        "instead of max-batch (e.g. 1,4,8); every bucket runs "
                        "once on the device before the socket opens")
    p.add_argument("--index", default=None, help="WLASL index for gloss names")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
