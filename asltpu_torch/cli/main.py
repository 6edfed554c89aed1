"""CLI: ``predict | serve | train | eval | export | landmarks | bench``, the
entry points of the port. Counterpart of ``asltpu/cli/main.py``.

Usage:
  python -m asltpu_torch.cli predict CLIP.mp4 [--model mobilenet_gru] [--ckpt PATH]
  python -m asltpu_torch.cli predict SESSION.mp4 --windows 2.0 [--window-stride 1.0]
  python -m asltpu_torch.cli predict --exported DIR CLIP.mp4
  python -m asltpu_torch.cli serve --model mobilenet_gru --batch-buckets 1,4,8
  python -m asltpu_torch.cli train --model mobilenet_gru --index WLASL.json --videos DIR ...
  python -m torch.distributed.run --nproc-per-node 2 -m asltpu_torch.cli train \
      --model resnet_transformer --model-parallel 2 --index ... --videos DIR ...
  python -m asltpu_torch.cli eval --model ... --index ... --videos DIR --split test
  python -m asltpu_torch.cli export --model ... --out DIR [--verify-clip CLIP.mp4]
  python -m asltpu_torch.cli landmarks --index ... --videos DIR --out DIR
  python -m asltpu_torch.cli bench [benchmark arguments...]

Every subcommand that runs a model takes ``--device`` (the card by default;
``cpu`` runs on the host); ``predict --exported`` runs where its artifact
was exported.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import tempfile
from typing import List, Optional

from asltpu_torch.utils.logging import MetricsWriter, get_logger

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


def _check_model_name(name: str) -> None:
    from asltpu_torch.config import CONFIG_REGISTRY

    if name not in CONFIG_REGISTRY:
        raise SystemExit(
            f"error: unknown model '{name}'; choose from "
            f"{', '.join(sorted(CONFIG_REGISTRY))}"
        )


def _load(args):
    from asltpu_torch.api import load_model

    _check_model_name(args.model)
    return load_model(args.model, checkpoint=args.ckpt, device=args.device,
                      **_model_overrides(args))


def _gloss_names(args, model):
    from asltpu_torch.data.wlasl import WLASLIndex

    if not args.index:
        return None
    return WLASLIndex(args.index, getattr(args, "videos", None) or "",
                      subset=model.cfg.num_classes).glosses


def _landmarks_for(args, model, what: str):
    """``LandmarkStore(--landmarks-dir).for_path(T)`` for a model that takes
    landmarks, None for one that does not; a missing directory exits."""
    if not model.takes_landmarks:
        return None
    if not args.landmarks_dir:
        raise SystemExit(
            f"error: {what} consumes landmarks; pass --landmarks-dir with "
            "precomputed <video_id>.npy files"
        )
    from asltpu_torch.data.landmarks import LandmarkStore

    return LandmarkStore(args.landmarks_dir).for_path(model.cfg.num_frames)


def cmd_predict(args) -> int:
    # Inputs are checked before the model loads.
    missing = [c for c in args.clips if not os.path.exists(c)]
    if missing:
        raise SystemExit(f"error: clip(s) not found: {', '.join(missing)}")
    if args.exported:
        if args.windows is not None:
            raise SystemExit(
                "error: --windows runs the batched streaming lane; an export "
                "artifact is the single-clip deployment lane (build the model "
                "with --model/--ckpt for continuous recognition)"
            )
        return _predict_exported(args)
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
    landmarks_for = _landmarks_for(args, model, f"model '{args.model}'")
    from asltpu_torch import api

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


def _predict_exported(args) -> int:
    """``predict --exported DIR clip...``: run an export artifact
    (:mod:`asltpu_torch.export`) one clip at a time, with no model code;
    the artifact's program runs where it was exported."""
    import torch

    from asltpu_torch.data.decode import decode_clip
    from asltpu_torch.export import load_exported

    em = load_exported(args.exported)
    if args.device is not None and em.device != torch.device(args.device):
        raise SystemExit(
            f"error: the artifact runs on {em.device} (where it was exported), "
            f"not on --device {args.device}"
        )
    gloss_names = _gloss_names(args, em)
    landmarks_for = _landmarks_for(args, em, "the exported model")
    for path in args.clips:
        kw = {}
        if em.takes_rgb:
            kw["frames"] = decode_clip(path, em.preprocess)
        if em.takes_landmarks:
            kw["landmarks"] = landmarks_for(path)
        gloss, logits = em.predict(gloss_names=gloss_names, **kw)
        print(json.dumps({"clip": path, "gloss": gloss, "top5": _top5(logits, gloss_names)}))
    return 0


def cmd_export(args) -> int:
    """Export the model's inference program (:mod:`asltpu_torch.export`);
    with ``--verify-clip``, load the artifact back and predict the clip
    through it."""
    from asltpu_torch.export import export_model, load_exported

    model = _load(args)
    meta = export_model(model, args.out, batch_size=args.batch)
    print(json.dumps({"out": args.out, **{key: meta[key] for key in (
        "family", "batch_size", "platforms", "preprocess", "inputs")}}))
    if args.verify_clip:
        from asltpu_torch.data.decode import decode_clip

        em = load_exported(args.out)
        if em.takes_landmarks:
            raise SystemExit(
                "error: --verify-clip takes RGB-only models (landmark inputs "
                "need --landmarks-dir; use predict --exported)"
            )
        gloss, logits = em.predict(frames=decode_clip(args.verify_clip, em.preprocess))
        print(json.dumps({"verify_clip": args.verify_clip, "gloss": gloss,
                          "top5": _top5(logits, None)}))
    return 0


def _train_config_overrides(args) -> dict:
    """The model overrides of ``train``: ``--set``/``--num-classes``, then
    ``--frames`` and ``--crop`` (staging and resize scale with the crop by
    256/224)."""
    overrides = _model_overrides(args)
    pp = dict(overrides.get("preprocess", {}))
    if args.frames:
        pp["num_frames"] = args.frames
    if args.crop:
        pp.update(crop=args.crop, resize_short=round(args.crop * 256 / 224),
                  staging_size=(round(args.crop * 256 / 224),) * 2)
    if pp:
        overrides["preprocess"] = pp
    return overrides


def cmd_train(args) -> int:
    """Train or fine-tune an RGB model on a WLASL index: decoded clips →
    (augmented) train steps → checkpoints, with periodic eval on
    ``--eval-split``; a rerun with the same ``--ckpt-dir`` resumes."""
    import numpy as np

    from asltpu_torch import api
    from asltpu_torch import ckpt
    from asltpu_torch.config import TrainConfig, get_config
    from asltpu_torch.data.decode import decode_record, make_decode_pool
    from asltpu_torch.data.pad import pad_to_batch
    from asltpu_torch.data.prefetch import Prefetcher
    from asltpu_torch.data.wlasl import WLASLIndex, batches_from_records
    from asltpu_torch.ops.augment import AugmentConfig
    from asltpu_torch.train.loop import train

    _check_model_name(args.model)
    overrides = _train_config_overrides(args)
    cfg = get_config(args.model, **overrides)
    _check_model_parallel(cfg, args.model_parallel)
    if not hasattr(cfg, "preprocess") or hasattr(cfg, "num_landmarks"):
        raise SystemExit(
            "error: CLI training decodes RGB clips only; landmark-consuming "
            "models (pose_bilstm, two_stream) train through the library "
            "(asltpu_torch.train.loop.train) with precomputed landmarks"
        )
    tcfg = TrainConfig(
        batch_size=args.batch, num_steps=args.steps, learning_rate=args.lr,
        **({"warmup_steps": args.warmup} if args.warmup is not None else {}),
        ckpt_dir=args.ckpt_dir, log_every=args.log_every, ckpt_every=args.ckpt_every,
        eval_every=args.eval_every, fault_inject_step=args.fault_inject_step,
    )
    mesh = _train_mesh(args, tcfg.batch_size)
    ds = WLASLIndex(args.index, args.videos, subset=cfg.num_classes)
    records = ds.split("train")
    if not records:
        log.error("no train clips with videos on disk")
        return 2
    if len(records) < tcfg.batch_size:
        # Batches drop their remainder: fewer records than one batch would
        # yield nothing, forever.
        raise SystemExit(
            f"error: {len(records)} train clips < batch size {tcfg.batch_size}; "
            "lower --batch or add data"
        )
    pp = cfg.preprocess
    model = api.build_trainable(args.model, device=_rank_device(args.device), **overrides)

    resumable_iter = raw_iter = None
    if args.loader == "grain":
        # The resumable loader: its position is saved with each checkpoint,
        # so a resumed run continues the data stream.
        from asltpu_torch.data.loader import ResumableIterator, make_train_loader

        raw_iter = iter(make_train_loader(records, pp, tcfg.batch_size, seed=tcfg.seed,
                                          num_epochs=None, worker_count=args.loader_workers))
        saved = ckpt.load_data_state(args.ckpt_dir)
        if saved is not None:
            raw_iter.set_state(saved)
            log.info("restored the loader's position from %s", args.ckpt_dir)
        resumable_iter = ResumableIterator(raw_iter)

        def batches():
            yield from resumable_iter
    else:

        def batches():
            pool = make_decode_pool(pp, num_workers=4)
            try:
                for recs in batches_from_records(records, tcfg.batch_size, seed=tcfg.seed):
                    # One clip that does not decode must not end a long run:
                    # it is skipped (logged by the pool), and the batch is
                    # padded by repeating its last clip, labels alike.
                    for frames, kept in pool.map_batches(recs, tcfg.batch_size, "skip"):
                        labels = pad_to_batch(np.asarray([recs[k].label for k in kept],
                                                         np.int32), tcfg.batch_size)
                        yield frames, labels
            finally:
                pool.shutdown()

    if args.debug_nans:
        from asltpu_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)

    eval_batches = None
    eval_records = ds.split(args.eval_split) if args.eval_split else []
    if eval_records:
        eval_cache: list = []

        def eval_batches():
            # Decoded once and reused by every eval. The last batch is
            # padded: frames by repeating its last clip, labels with -1,
            # which the eval leaves out of its counts.
            if not eval_cache:
                for i in range(0, len(eval_records), tcfg.batch_size):
                    recs = eval_records[i : i + tcfg.batch_size]
                    frames = pad_to_batch(np.stack([decode_record(r, pp) for r in recs]),
                                          tcfg.batch_size)
                    labels = pad_to_batch(np.asarray([r.label for r in recs], np.int32),
                                          tcfg.batch_size, fill=-1)
                    eval_cache.append((frames, labels))
            yield from eval_cache

    try:
        state = train(
            model.module, tcfg, Prefetcher(batches(), depth=2, device=model.device),
            pp_cfg=pp, metric_writer=MetricsWriter(args.log_dir),
            augment=None if args.no_augment else AugmentConfig(),
            eval_batches=eval_batches, resumable_iter=resumable_iter, mesh=mesh,
        )
    finally:
        if raw_iter is not None:
            raw_iter.close()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    log.info("training done at step %d", state.step)
    return 0


def _check_model_parallel(cfg, model_parallel: int) -> None:
    """``--model-parallel`` against the config's shapes, by the fields the
    config has (a config without attention shards nothing and trains
    replicated), before any data is read or the model is built."""
    if model_parallel == 1:
        return
    from asltpu_torch.dist.tp import validate_config_tp

    try:
        if model_parallel < 1:
            raise ValueError(f"must be at least 1, got {model_parallel}")
        validate_config_tp(cfg, model_parallel)
    except ValueError as e:
        raise SystemExit(f"error: --model-parallel: {e}")


def _train_mesh(args, batch_size: int):
    """The (data, model) mesh of this process: under ``torchrun`` (its
    environment) the world it joins with ``--dist-backend``, laid out with
    ``--model-parallel``; alone, the one-rank mesh (which refuses a model
    axis above 1)."""
    from asltpu_torch.dist import init_distributed, make_mesh

    init_distributed(backend=args.dist_backend)
    try:
        mesh = make_mesh(model_parallel=args.model_parallel)
    except ValueError as e:
        raise SystemExit(f"error: --model-parallel: {e} (launch one process per rank "
                         "with python -m torch.distributed.run)")
    if batch_size % mesh.data_size:
        raise SystemExit(f"error: --batch {batch_size} not divisible by the data axis "
                         f"({mesh.data_size} ranks)")
    return mesh


def _rank_device(device: Optional[str]) -> Optional[str]:
    """``--device``; by default, in a world of ranks on CUDA devices, the
    card of this rank's ``LOCAL_RANK`` (modulo the cards there are, so that
    gloo ranks may share one)."""
    if device is not None or "LOCAL_RANK" not in os.environ:
        return device
    import torch

    if not torch.cuda.is_available():
        return device
    return f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}"


def cmd_eval(args) -> int:
    """Top-1/top-5 (``--per-class``: and per gloss) of a model on a WLASL
    split, one JSON line."""
    from asltpu_torch.config import CONFIG_REGISTRY
    from asltpu_torch.data.wlasl import WLASLIndex
    from asltpu_torch.eval.metrics import evaluate_split

    _check_model_name(args.model)
    # The gloss subset is the model's class count (i3d: WLASL-2000), from
    # either override spelling, so the split scored is the one the model
    # was built for. The index is read before the model is built, so a bad
    # path or an empty split fails first.
    subset = _model_overrides(args).get("num_classes",
                                        CONFIG_REGISTRY[args.model]().num_classes)
    ds = WLASLIndex(args.index, args.videos, subset=subset)
    if not ds.split(args.split):
        raise SystemExit(f"error: no clips with videos on disk for split '{args.split}'")
    model = _load(args)
    metrics = evaluate_split(
        model, ds.split(args.split), batch_size=args.batch, max_clips=args.max_clips,
        landmarks_for=_landmarks_for(args, model, f"model '{args.model}'"),
        skip_errors=args.skip_errors, per_class=args.per_class, gloss_names=ds.glosses,
    )
    print(json.dumps(metrics))
    return 0


def cmd_landmarks(args) -> int:
    """Dataset preparation: extract and store the landmarks of WLASL splits
    (host only)."""
    from asltpu_torch.data.landmarks import (
        LandmarkStore,
        MediaPipeExtractor,
        SyntheticExtractor,
        precompute_landmarks,
    )
    from asltpu_torch.data.wlasl import WLASLIndex

    ds = WLASLIndex(args.index, args.videos, subset=args.num_classes)
    records = [r for s in args.splits.split(",") for r in ds.split(s)]
    if not records:
        raise SystemExit("error: no clips with videos on disk")
    extractor = (MediaPipeExtractor() if args.extractor == "mediapipe"
                 else SyntheticExtractor(num_frames=64))
    n = precompute_landmarks(records, LandmarkStore(args.out), extractor,
                             overwrite=args.overwrite)
    print(json.dumps({"written": n, "store": args.out}))
    return 0


def cmd_bench(rest: List[str]) -> int:
    """``python -m asltpu_torch.benchmark`` with the arguments that follow
    ``bench``."""
    from asltpu_torch.benchmark import main as bench_main

    return bench_main(rest)


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
    p.add_argument("--exported", default=None, metavar="DIR",
                   help="run an export artifact (export) instead of building "
                        "a model: no model code")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("export", help="export the inference program for deployment")
    _add_model_args(p)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--batch", type=int, default=8,
                   help="the program's fixed batch size (callers pad, as the "
                        "server does)")
    p.add_argument("--verify-clip", default=None, metavar="CLIP",
                   help="after the export, load the artifact and predict this "
                        "clip through it (RGB models)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("train", help="train or fine-tune a model")
    _add_model_args(p)
    p.add_argument("--index", required=True)
    p.add_argument("--videos", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=None,
                   help="LR warmup steps (default: TrainConfig's 500; a short "
                        "run wants this well below --steps)")
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "asltpu_torch_ckpt"))
    p.add_argument("--log-dir", default=None,
                   help="write the metrics as CSV here (train_metrics.csv, "
                        "train_metrics_eval.csv)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--fault-inject-step", type=int, default=-1,
                   help="raise at step N, to test resume")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection: a NaN in the backward "
                        "raises, naming the forward op")
    p.add_argument("--eval-split", default=None,
                   help="run top-1/top-5 on this split every --eval-every steps")
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--frames", type=int, default=None, help="override the clip's frame count")
    p.add_argument("--crop", type=int, default=None,
                   help="override the crop (staging and resize scale with it)")
    p.add_argument("--no-augment", action="store_true",
                   help="turn train-time augmentation off")
    p.add_argument("--loader", choices=["records", "grain"], default="records",
                   help="input pipeline: 'grain' = deterministic and resumable "
                        "(its position saved with each checkpoint); 'records' "
                        "= a shuffle of the records through a decode pool")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="decode processes of the 'grain' loader (0 = decode "
                        "in the prefetch thread)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="size of the mesh's model axis (tensor parallelism, "
                        "asltpu_torch.dist.tp): Megatron-shards the transformer "
                        "head's attention/MLP parameters and their AdamW moments; "
                        "the ranks (python -m torch.distributed.run) must divide "
                        "by it. Models without attention train replicated under it")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend under torch.distributed.run "
                        "(default: nccl with a CUDA device, else gloo; two ranks "
                        "on one GPU need gloo)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="top-1/top-5 on a WLASL split")
    _add_model_args(p)
    p.add_argument("--index", required=True)
    p.add_argument("--videos", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--landmarks-dir", default=None,
                   help="precomputed <video_id>.npy landmarks (pose/fusion)")
    p.add_argument("--skip-errors", action="store_true",
                   help="skip undecodable clips instead of failing")
    p.add_argument("--per-class", action="store_true",
                   help="also report macro_top1 (mean per-class accuracy) and "
                        "the per-gloss breakdown, worst first")
    p.set_defaults(fn=cmd_eval)

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

    p = sub.add_parser("landmarks", help="precompute pose landmarks of WLASL splits")
    p.add_argument("--index", required=True)
    p.add_argument("--videos", required=True)
    p.add_argument("--out", required=True, help="output .npy store directory")
    p.add_argument("--num-classes", type=int, default=100)
    p.add_argument("--splits", default="train,val,test")
    p.add_argument("--extractor", choices=["mediapipe", "synthetic"], default="mediapipe")
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(fn=cmd_landmarks)

    # main() hands everything after "bench" to the benchmark's own parser.
    p = sub.add_parser("bench", help="run the port's benchmark (asltpu_torch.benchmark)")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    p.set_defaults(fn=lambda args: cmd_bench(args.rest))
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        return cmd_bench(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)
