#!/usr/bin/env python3
"""Smoke run of the asltpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``asltpu_torch/csrc`` and runs, in order, each
phase printing one JSON line:

1. device  — the card (``nvidia-smi`` name and power limit), versions, the
   kernel build time and ptxas's register counts; TF32 is switched off so
   the fp32 comparisons are fp32.
2. kernels — every kernel against its plain PyTorch version on the card, at
   the main path's shapes, at a ragged one and at a tail one (rgb crop 50,
   yuv420 width 52: rows that are not 16-byte multiples), rgb also at
   TimeSformer-HR's (8 clips of 16 × 512² to 448²), in bf16 and fp32;
   the main rgb shape must be bit-exact in bf16. Kernel and plain times by
   CUDA events around runs of back-to-back calls, beside the least time the
   card could take (``share_of_bound``), the first kernels' times on the
   same card model (``earlier_ms``) and, as information, a device-to-device
   ``copy_`` of the same total bytes (``copy_ms_info``: the card's practical
   streaming rate, not a yardstick of the same function).
3. rgb lane — ``load_model("mobilenet_gru")`` at full width and the default
   config, ``predict`` on a seeded batch of 32 clips × 16 frames of 256²
   RGB; the rgb kernel must have launched, and the logits must match the
   same model with ``use_pallas=False`` (plain preprocess on the card).
   Then the comparison on logits that vary: the same lane with an fp32
   model (fp32 preprocess out) whose BN is calibrated on a seeded batch,
   its state copied into the ``use_pallas=False`` twin, both fed 32 clips
   of smooth moving patterns that differ from clip to clip; the clip-to-
   clip spread of the logits must be at least 1e-3, kernel and plain
   logits within 1e-3 of that spread, and the same top-1 wherever the
   plain margin exceeds twice their difference. Then device-only times by
   CUDA events (bf16 model): a predict with each model, and its three
   stages (preprocess, backbone, GRU head) one by one.
   Every loaded model's BatchNorm and LayerNorm parameters and buffers
   must be fp32 (the compute dtype is bf16).
4. yuv420 lane — the same with the transfer-thin I420 config (224² staging).
5. resnet lane — ``load_model("resnet_transformer")`` at full width
   (ResNet-18, a 4-layer transformer head of width 512, 300 classes) on
   the rgb lane, ``predict`` on 16 clips × 32 frames of 256² RGB, with the
   same checks as the rgb lane: the rgb kernel launched, logits against
   the ``use_pallas=False`` twin, the fp32 comparison on varied clips with
   calibrated BN, device-only times and the stage times.
6. kernels_mbconv — the fused MBConv kernels against their plain version at
   the seven block shapes of the full-width backbone on 512 frames of 224²:
   bf16 x runs the TF32 tensor-core kernel (``tf32_wmma``, within one bf16
   ulp of the largest output), fp32 x the CUDA-core kernel (``fp32_fma``,
   1e-4 relative); per shape the tile each took, the bf16 kernel's and the
   plain version's times, the bound (operations at the bf16 tensor-core
   peak), the first kernel's time on the same card model (``earlier_ms``)
   and (information only) the port's cuDNN ``InvertedResidual`` of the
   same shape.
7. fused_backbone — the rgb lane's batch through preprocess (rgb kernel),
   ``fused_backbone_apply`` (12 fused MBConv launches) and the GRU head,
   against ``predict`` on the same batch: features, logits and top-1. Then,
   with BN statistics calibrated on a seeded batch (at the seeded init the
   features vanish), each of the fused path's 19 layers against the
   module's own layer on the same input, and (information) both bf16
   backbones against the fp32 one. Then the fused and the cuDNN backbone
   timed by CUDA events, and their peak memory.
8. host — ``load_clip`` → ``predict`` and ``stream_predict`` on synthetic
   videos, when OpenCV is installed.
9. decode_backends — the native decode libraries (``asltpu_torch.native``,
   host C++ built with g++) on 4 fresh synthetic mp4s and one clip record
   with a segment and a signer box, on both wire lanes: where g++ and the
   OpenCV 4 headers are present the OpenCV library must build and give
   the bytes of the cv2 path; where the libav headers are present the av
   library must stay within a mean absolute difference of 3.0 of it (6.0
   for the record with a box, 8.0 with ``FAST_ALL``). A library whose toolchain is missing prints
   ``"ran": false`` with the path looked for; one that fails to build with
   its toolchain present fails the run. Then ``stream_predict`` with
   ``decode_backend="auto"`` over the same items names the backend it
   chose, and its top-1 must equal ``predict``'s on the same clips staged
   by the cv2 path.
10. i3d lane — ``load_model("i3d")`` at full width (the Inception-v1
   network inflated to 3D, 2000 classes) on the rgb lane, ``predict`` on a
   seeded batch of 4 clips × 64 frames of 256² RGB, with the same checks
   as the rgb lane; the comparison on varied clips calibrates every
   BatchNorm3d through the whole 3D backbone. The predict must launch the
   max-pool kernels 13 times forward and none backward; it is timed with
   them and with aten's pools in their place, in turns.
11. two_stream lane — ``load_model("two_stream")`` at full width
   (MobileNetV2 ×1.0, d_model 256, 8 heads, 2 cross-attention layers, 100
   classes) on the rgb lane, ``predict`` on 16 clips × 16 frames of 256²
   RGB with seeded landmarks 16 × 16 × 543 × 3, with the same checks.
12. stem — I3D's stem conv (7×7×7, stride 2, SAME, 3 → 64) in its two
   forms, the plain strided conv and the space-to-depth rewrite, at the
   contract shape [4, 64, 224, 224, 3] bf16: within one bf16 ulp of the
   largest output of each other, both times in turns (plain, s2d, s2d,
   plain) beside the bound, and the form the model runs.
13. pose_lane — ``load_model("pose_bilstm")`` at full width (543 × 3
   landmarks, 32 frames, hidden 256, 2 layers, 100 classes) on the card,
   ``predict`` on a seeded batch of 64 with cuDNN's TF32 allowed (PyTorch's
   default): fp32 logits within 1e-5 of the same weights on the CPU, and
   the control, TF32 on inside the LSTM, must leave that bound; the
   pose-only ``stream_predict`` over a
   ``LandmarkStore.for_path`` gives ``predict``'s logits; device-only
   clips/s by CUDA events. The pose path runs no preprocess kernel.
14. bench — ``asltpu_torch.benchmark`` in this process over its seven
   (family, lane) cells with a short stream, the decode pool at 4
   workers and ``--trace`` into a temporary directory (the ``i3d:train``
   cell in its two configurations); its result line. The two
   ``mobilenet_gru`` cells carry the 640×480 block: decode-only by backend
   and by worker count with the fit ``min(workers * r1, device_rate)``,
   ``stream_predict`` over 3 batches of 32 fresh 640×480 mp4s at full
   width, whose top-1 must equal ``predict``'s and whose capture must hold
   the lane kernel's CUDA events, one per predict (``preprocess_rgb`` /
   ``preprocess_yuv420``), and the decode-fast gate (not run where libav
   does not build). Each captured stream's device busy share, the 640×480
   rates and the gate print on lines of their own.
15. train (run after the two_stream lane) — I3D fine-tuning at full
   width: ``build_trainable("i3d")`` (2000 classes, 64 frames of 256²
   staged, crop 224, bf16 compute with fp32 masters, remat on) at
   ``TrainConfig``'s batch of 8. The first step (lr 0) against a twin with
   ``use_pallas=False`` (loss and grad_norm) and against remat off (the
   same loss, running statistics updated once), with the peak memory of
   each; the fp32 step at the CPU test's size on the card against the CPU;
   ``train()`` for 10 steps on one fixed batch (warmup 2), the loss must
   fall, then its eval (2 batches) and keep-best; a run cut by an injected
   fault after its step-4 checkpoint resumed in this process: the step
   count, the batches, the generator's state and the lr equal the
   uninterrupted run's, its losses within three times the spread of the
   runs that were not cut. The rgb kernel must launch once in each
   train and each eval step, the max-pool kernels 22 forward (13 and the
   remat recompute's 9) and 13 backward a train step and 13 forward an
   eval batch; the other families launch none. Checkpoints go to a temporary directory. The
   step's timings come from the bench phase's ``i3d:train`` cell (batch 8,
   remat on): ms a step by CUDA events, train clips/s, peak GB, GFLOP per
   clip of forward + backward (recompute apart) and MFU, each printed on a
   line of its own after the bench's result line.
   Then, one line each, ``mobilenet_gru`` (MobileNetV2 ×1.0, GRU 512, 100
   classes, 16 frames), ``resnet_transformer`` (ResNet-18, a 4-layer head
   of width 512, 300 classes, 32 frames) and ``two_stream`` (d_model 256,
   2 layers, 16 frames with seeded landmarks [8, 16, 543, 3]) at full
   width, bf16 compute with fp32 masters, batch 8 from 256² RGB staged:
   the first step (lr 0) against its ``use_pallas=False`` twin (the same
   loss, grad_norm within 1e-2) with its peak memory; the fp32 step at the
   CPU test's size on the card against the CPU; ``train()`` with eval on 2
   batches and keep-best (``mobilenet_gru``: 10 steps on one fixed batch,
   the loss must fall, then the fault and resume as I3D's; the others 4
   steps, ``two_stream`` on ``((clip, landmarks), labels)`` batches), the
   rgb kernel launched once in each train and each eval step; then the
   step timed by CUDA events (input varied per step): ms a step, train
   clips/s, peak GB, GFLOP per clip of forward + backward
   (``FlopCounterMode``, a grouped conv's weight gradient per group) and
   MFU, each printed on a line of its own.
16. serve (run after pose_lane) — ``asltpu_torch.serve_http.serve`` at
   full width: ``mobilenet_gru`` on the rgb lane with its BatchNorm
   calibrated on 8 other mp4s of the same kind (``max_batch`` 32, buckets
   1, 4, 8, 32, warmed) answers 12 distinct 320×240 mp4s posted to
   /predict by 12 client threads at once:
   each response's top-5 logits within 1e-2 of ``predict`` on the same
   clip through ``load_clip`` (the same gloss wherever predict's margin
   exceeds twice that), the logits spreading over ten times the bound
   and any two clips' logits more than twice it apart,
   /stats with an average batch above 1; /predict_windows (2 s windows, 1
   s stride) on a 10 s session against ``predict_windows`` on the same
   file (spans, ids where the margin allows, probabilities within 5e-3).
   Then ``two_stream`` (calibrated) on /predict_fusion with seeded
   landmarks, ``pose_bilstm`` on /predict_landmarks and
   /predict_windows_landmarks (within 1e-5 of ``predict`` and
   ``predict_windows_landmarks``), a yuv420-staged ``mobilenet_gru`` on
   /predict, each against ``predict`` on the same input; every server is
   shut down and its threads must end. Then ``benchmark.serve_curve`` on
   the rgb model (p50, p99, clips/s at concurrency 1, 4 and 32) and the
   host → device copy's share of a batch per bucket, printed on lines of
   their own at the end.
17. export (run after serve) — ``asltpu_torch.export.export_model`` of
   each config at full width and its bench batch (``mobilenet_gru`` on
   both lanes, ``resnet_transformer``, ``i3d``, ``two_stream``,
   ``pose_bilstm``), random weights from the seed, BatchNorm calibrated on
   varied clips; each artifact's meta must name the kernel op its program
   calls. A fresh interpreter loads every artifact and runs it on varied
   clips (and seeded landmarks): ``asltpu_torch.models`` and the api must
   stay out of its ``sys.modules``, the rgb kernel must launch at least
   once in each rgb program and the yuv420 kernel in the yuv420 one, and
   the logits must lie within 1e-2 of the live ``predict_fn``'s (the gap
   printed). Exported and live device ms by CUDA events, in turns, each
   printed on a line of its own with the graph's size and its RNN ops.
18. learn — ``make_separable_wlasl`` (6 glosses, 8 train and 4 val clips
   each) → ``asl train --model mobilenet_gru`` with the JAX proof's
   arguments (tests/integration/test_learning.py) and the resumable
   loader with 4 decode workers: final held-out top-1 ≥ 0.8, every eval
   scoring all 24 clips; the checkpoint through ``asl eval`` (top-1 ≥ 0.8
   on the 24), ``asl export`` (the rgb kernel op in its program) and ``asl
   predict --exported`` on a val clip, whose gloss must be ``asl predict
   --ckpt``'s. Then the ``pose_bilstm`` (≥ 0.9) and ``two_stream``
   cross-modal (≥ 0.75) proofs through ``train()``, and 12 full-width ``asl
   train`` steps (``mobilenet_gru`` defaults, batch 8, no augment, 4 loader
   workers) with the median step time on the host clock on a line of its
   own.
19. dist (run after bench) — distribution on the one card, each check's
   gaps printed: (a) a one-rank NCCL group (``init_distributed`` with
   ``backend="nccl"``) whose mesh runs every data-parallel collective
   (BatchNorm's global statistics, the gradient all-reduce, the metrics)
   through NCCL: two full-width ``mobilenet_gru`` train steps at batch 8,
   bf16 and fp32, against the same steps in one process; (b) two rank
   processes (``chip_smoke.py --dist-rank``) in a gloo group on cuda:0 (NCCL
   puts no two ranks of a group on one device): the same two DP steps at
   global batch 8 (4 rows a rank), bf16 and fp32, against the one-process
   steps; (c) in the same ranks, two TP=2 train steps of the full-width
   ``resnet_transformer`` in fp32 (the contract head sharded) against the
   replicated steps; (d) in the same ranks, sharded predict: 16 calibrated
   clips a rank, logits gathered over the group, against one process's
   predict of the 32 (1e-2, the lanes' bound, on logits spreading ≥ 1e-3);
   (e) ``asl train --model resnet_transformer --model-parallel 2
   --dist-backend gloo`` under ``python -m torch.distributed.run
   --standalone --nproc-per-node 2`` (each rank runs this script's
   ``--cli-rank`` entry, which calls ``asltpu_torch.cli``'s main as ``python
   -m asltpu_torch.cli`` does and writes its kernel launches) on synthetic
   records (16 clips of 32 frames of 256²), 4 steps at batch 8 with a fault
   at step 3, then a rerun that resumes from the step-2 checkpoint rank 0
   wrote and ends at step 4. The bounds are the ``DIST_*`` constants (their
   comments say why); every rank joins with a 60 s collective timeout, the
   ranks are joined within 100 s and each torchrun call within 90 s (then
   killed with their process group). The host-clock step times print on
   lines of their own before the card's line, as information: two gloo
   ranks share one card and stage every collective through the host, so no
   number here is a multi-GPU scaling figure.
20. pool3d (run after stem) — I3D's max-pool kernels
   (``asltpu_torch/csrc/pool3d.cu``, the op ``asltpu_torch::max_pool3d_same``
   and its backward) at the 13 pools of full-width I3D on 48 clips × 64
   frames of 224² (their shapes from the model's backbone on the meta
   device), bf16 with all-equal windows and a NaN: the forward bit for bit
   against aten's ``max_pool3d`` after ``pad_same``'s −inf copy, the offsets
   against the plain version's, the input gradient within one bf16 ulp of
   aten's taken in fp32 and rounded once (aten's own bf16 gradient beside
   it, as information); forward and backward times by CUDA events in turns
   (aten, kernel, kernel, aten) beside the bytes' bound, aten's as
   ``library_ms``. Then C = 132 and fp32 at small shapes, unmeasured, and
   C = 3 and an unaligned view, which the op must refuse; then one I3D
   train step at batch 2 with remat off and on, each against the same step
   with aten's pools (loss and grad_norm as the train phase bounds them),
   the kernels' launches a step (13 + 13; remat: 22 + 13). The kernels
   line takes its launches from the main paths: the i3d lane's predict,
   phase train's ``train()`` and eval, and the exported ``i3d/rgb``.
21. timesformer (run after train) — TimeSformer-HR at its published
   widths (ViT-B/16, 12 divided blocks, 16 frames of 448² from 512², 2000
   classes, bf16 with fp32 norms) on its two main paths, at the batch of
   the benchmark's ``timesformer_hr.finetune_b8``: ``load_model`` →
   ``predict`` on 8 staged clips (finite logits; the same predict with the
   plain preprocess within ``LANE_LOGIT_ATOL``), then ``build_trainable``
   → ``make_train_step``, two steps on seeded batches (finite loss and
   gradient norm). On each path the rgb kernel's launches (1), the fused
   attention's calls (12 a forward: the spatial sub-layers), the short-
   sequence kernels' launches (12 forward a forward: the temporal
   sub-layers; 12 backward a train step) and the plain attention's calls
   (0) are set to 0 just before the run and read from it, with its peak
   memory.
22. short_attention (run after timesformer) — the short-sequence attention
   kernels (``asltpu_torch/csrc/short_attention.cu``, the op
   ``asltpu_torch::short_attention`` and its backward) at TimeSformer-HR's
   temporal layer at batch 8 (6,272 sequences of 16 tokens, 12 heads of
   64, bf16): the output and the gradient of ``qkv`` against the plain
   version in fp32 on the same inputs (within 2^-6 of each tensor's
   largest value: bf16 rounds P, dS and the results), two backward runs
   bit for bit; forward and backward times by CUDA events in turns
   (library, kernel, kernel, library) beside the bytes' bound, the plain
   version's time, and as ``library_ms`` PyTorch's fused attention (cuDNN
   first) on q, k, v views of the same projection with autograd's backward
   to ``qkv``, the path the kernels replaced, timed only as a yardstick.
23. window_attention (run after short_attention) — the window attention
   kernels (``asltpu_torch/csrc/window_attention.cu``, the op
   ``asltpu_torch::window_attention`` and its backward) at a shifted layer
   of Video Swin-B's third stage at batch 8 (64 windows × 16 heads × 392
   tokens) and of its first (1024 × 4), bf16 with the table in fp32: the
   output, the gradient of ``qkv`` (within 2^-8 of each tensor's largest
   value: each rounded once to bf16) and the table's (2^-8: fp32 sums in
   the atomics' order) against
   the plain version in fp32 on the same inputs; forward and backward
   times by CUDA events in turns (library, kernel, kernel, library) beside
   the matmuls' bound at 989 TFLOP/s, the plain version's time, and as
   ``library_ms`` the path the kernels replaced, timed only as a
   yardstick: the table gathered, cast to bf16, plus the mask, repeated
   over the clips and padded, PyTorch's memory-efficient attention, and
   autograd's backward to ``qkv`` and the table (the bias gradient's sum
   over the windows and its scatter).

The kernels' launch counts are read per path: each lane (and the fused
path) sets them to 0 just before its ``predict`` and reads them just after;
the train phase sets them to 0 just before each family's ``train()`` run
and reads its train steps' launches when the run's eval begins, its eval's
after it; phase serve sets them to 0 once each server is warm, just before
its HTTP requests, and reads them when the responses are in; phase export
counts each artifact's run in the fresh process (``export/<config>``), and
phase learn counts its ``asl train`` runs (``cli/train``); phase dist
counts (a) and (b) as ``dist/dp_train``, (c) as ``dist/tp_train``, (d) as
``dist/sharded_predict`` and (e) as ``dist/cli_train``, each rank process
from 0 before its run, reporting its count to this process; phase bench
counts each 640×480 stream (``bench/realistic_rgb``,
``bench/realistic_yuv420``) from 0 just before its ``stream_predict``.
Then the card's ``nvidia-smi`` line, the kernels' JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero; on
a host without a CUDA device it exits nonzero before doing anything. At the
end, after a failure too, it stops every process it started (the resource
tracker of the bench's process pools) and fails if any other is alive. It
imports nothing of JAX or of the ``asltpu`` package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 32  # clips per predict batch, as the JAX bench (bench.py --batch 32)
WARMUP, SAMPLES = 5, 10
# Back-to-back calls between one pair of CUDA events: enough that the
# host's time to enqueue the first call is a small share of the run.
KERNEL_REPS, PLAIN_REPS, PREDICT_REPS = 50, 10, 5
F32_ATOL = 1e-4
BF16_ATOL = {"rgb": 2e-2, "yuv420": 4e-2}  # one bf16 ulp at |x|≈2.6 / ≈4
# Logits of the same bf16 model with the kernel vs the plain preprocess: the
# two preprocess outputs differ by at most a bf16 rounding here and there.
LANE_LOGIT_ATOL = 1e-2
# The lanes' comparison on varied clips (fp32, calibrated BN): the logits
# must vary from clip to clip by at least VARIED_SPREAD_MIN (max |logits −
# their mean over clips|), and the fp32 kernel and plain preprocess (1e-6
# apart) must give logits within VARIED_ERR_RTOL of that spread.
VARIED_SPREAD_MIN = 1e-3
VARIED_ERR_RTOL = 1e-3
# H100 SXM data-sheet peaks.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# The fused MBConv's inputs and outputs are bf16, so a redesign on bf16
# tensor cores with fp32 sums does the same work: its operations are
# counted at that peak, so that no later kernel reads over 100%.
PEAK_BF16_FLOP_PER_S = 989e12
# The stride-1 expanded blocks of the full-width backbone at 224²:
# (H = W, Cin, Ce, Cout, launches per backbone call).
MBCONV_SHAPES = [
    (56, 24, 144, 24, 1), (28, 32, 192, 32, 2), (14, 64, 384, 64, 3),
    (14, 64, 384, 96, 1), (14, 96, 576, 96, 2), (7, 160, 960, 160, 2),
    (7, 160, 960, 320, 1),
]
# The first (CUDA-core, fp32 FMA) kernel's bf16 times at those shapes, ms,
# N = 512, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, row 3 per
# shape).
MBCONV_EARLIER_MS = [5.516395, 2.209434, 1.945686, 2.662811, 4.672517,
                     2.717293, 6.251677]
MBCONV_REPS = 10
MBCONV_F32_RTOL = 1e-4  # the kernel and the plain version sum in other orders
MBCONV_PATH = {torch.bfloat16: "tf32_wmma", torch.float32: "fp32_fma"}
# Fused vs cuDNN backbone (and layer vs layer) in bf16: BN folded before
# the bf16 conv rounds at other places than conv-then-BN; measured on the
# CPU: 0.0095 of the largest feature (tests/test_torch_mbconv.py), 0.004-
# 0.014 of the largest output per layer with calibrated BN.
FEATURE_RTOL = 2 ** -5
FUSED_LOGIT_ATOL = 5e-2  # the bf16 slice bound of tests/test_torch_api.py
# fp32 operations per output value: rgb 4 tap products + 3 adds (bilinear
# weights applied rows then columns: 6 mul + 3 add) + multiply-add normalize;
# yuv420 3 products + 3 adds + clamp (2) + the luma/chroma offsets.
OPS_PER_VALUE = {"rgb": 11, "yuv420": 9}
# The first (one thread per output pixel) preprocess kernels' bf16 times at
# the main shapes, ms, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6).
PREPROCESS_EARLIER_MS = {"rgb": 0.162533, "yuv420": 0.118643}
RGB_LANE = {}
YUV_LANE = {"staging_size": (224, 224), "resize_short": 224,
            "host_resize_short": 256, "staging_format": "yuv420"}
# Each family at full width (its config's defaults) and the JAX bench's
# batch (asltpu/benchmark.py:1298-1304).
FAMILIES = {
    "mobilenet_gru": {"batch": BATCH, "config": {
        "width_mult": 1.0, "gru_hidden": 512, "num_classes": 100}},
    "resnet_transformer": {"batch": 16, "config": {
        "d_model": 512, "num_heads": 8, "num_tx_layers": 4, "mlp_ratio": 4,
        "num_classes": 300, "num_frames": 32}},
    "i3d": {"batch": 4, "config": {"num_classes": 2000, "num_frames": 64}},
    "two_stream": {"batch": 16, "config": {
        "width_mult": 1.0, "d_model": 256, "num_heads": 8, "num_fusion_layers": 2,
        "num_classes": 100, "num_frames": 16}},
}
# I3D's stem at the contract shape: [B, T, H, W, 3] in, 64 channels out.
STEM_SHAPE, STEM_COUT, STEM_REPS = (4, 64, 224, 224, 3), 64, 10
# The av decoder against the cv2 path, as the JAX package bounds it
# (tests/unit/test_decode_av.py): mean absolute difference of the uint8
# bytes, exact av (a clip; a record with a signer box, whose crop may land
# one source pixel off cv2's) and with FAST_ALL.
AV_MAD, AV_BBOX_MAD, AV_FAST_MAD = 3.0, 6.0, 8.0
# TimeSformer-HR at the batch of the benchmark's timesformer_hr.finetune_b8;
# a forward of each of its 12 blocks calls the short-sequence kernel once
# (temporal, 16 tokens) and the fused attention once (spatial, 785).
TSF_BATCH, TSF_BLOCKS = 8, 12
# Its temporal attention a layer: 8 · 784 sequences of 16 tokens, 12 heads
# of 64 (phase short_attention).
SHORT_SHAPE, SHORT_HEADS, SHORT_REPS = (TSF_BATCH * 784, 16, 3 * 768), 12, 10
# Video Swin-B's shifted window layers at batch 8 (phase window_attention):
# (name, stage size, heads), each window 8×7×7 = 392 tokens, heads of 32.
WINDOW_LAYERS = [("stage3", (16, 14, 14), 16), ("stage1", (16, 56, 56), 4)]
WINDOW_BATCH, WINDOW_REPS = 8, 10
POSE_BATCH = 64  # the JAX bench's pose batch (asltpu/benchmark.py:1299)
# fp32 logits, card vs CPU, full width at batch 64: 1.04e-7 with the LSTM
# in fp32, 1.19e-4 with TF32 on inside it (NVIDIA H100 80GB HBM3, 700 W).
POSE_CPU_ATOL = 1e-5
# The bench phase: a short stream, small corpora and the process pool at 4
# workers only (each pool size spawns its workers anew; the full bench
# times 1, 2 and 4), so the whole script stays within half its limit.
BENCH_ARGS = ["--stream-batches", "4", "--windows", "2", "--corpus-clips", "8",
              "--mp4-batches", "2", "--decode-workers", "4"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Device time of one call: the median over ``SAMPLES`` runs of CUDA
    events around ``reps`` back-to-back calls, divided by ``reps``, after
    ``WARMUP`` calls (``asltpu_torch.benchmark.Clock``)."""
    from asltpu_torch.benchmark import Clock

    return Clock(torch.device("cuda"), reps, SAMPLES, WARMUP).ms(fn)


def pool_launches():
    """The max-pool kernels' launch counters, [forward, backward]."""
    from asltpu_torch.ops import pool3d_kernels as pk

    return [pk.max_pool3d_same.launches, pk.max_pool3d_same_backward.launches]


def reset_pool_launches():
    from asltpu_torch.ops import pool3d_kernels as pk

    pk.max_pool3d_same.launches = pk.max_pool3d_same_backward.launches = 0


# I3D's pools a forward, and those the remat recompute runs again.
I3D_POOLS = 13
I3D_REMAT_POOLS = 9


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    from asltpu_torch.benchmark import card_identity

    return card_identity()["nvidia_smi"]


def phase_device():
    from asltpu_torch.ops import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = _build.build(_build.all_sources())
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        with open(path.with_suffix(".log")) as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": round(build_s, 3), "ptxas": ptxas,
        "tf32": "off (cudnn.allow_tf32 = matmul.allow_tf32 = False)",
    })
    return smi


def rgb_input_bytes(cfg, in_hw) -> int:
    """Bytes of one staged frame that the rgb resize needs: the pixels whose
    row and column both carry a nonzero tap weight, 3 bytes each. At the
    main path's identity resize that is the centre 224² crop."""
    from asltpu_torch.ops.resize_mm import resize_crop_taps

    idx, w = resize_crop_taps(in_hw, cfg.resize_short, cfg.crop)
    rows = set(idx[0][w[0] != 0]) | set(idx[1][w[1] != 0])
    cols = set(idx[2][w[2] != 0]) | set(idx[3][w[3] != 0])
    return len(rows) * len(cols) * 3


def _uint8(rng, shape, device):
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)


def phase_kernels():
    from asltpu_torch.config import PreprocessConfig, get_config
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.ops.preprocess import preprocess_clip_interp

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    main_rgb = PreprocessConfig()
    main_yuv = PreprocessConfig(**YUV_LANE)
    x_rgb = _uint8(rng, (BATCH, 16, 256, 256, 3), dev)
    x_yuv = _uint8(rng, (BATCH, 16, 336, 224), dev)
    cases = [
        ("rgb", "main", x_rgb, main_rgb),
        ("rgb", "ragged", _uint8(rng, (4, 16, 240, 320, 3), dev),
         PreprocessConfig(staging_size=(240, 320))),
        ("yuv420", "main", x_yuv, main_yuv),
        ("yuv420", "ragged", _uint8(rng, (4, 16, 300, 200), dev),
         PreprocessConfig(staging_size=(200, 200), resize_short=200, crop=200,
                          staging_format="yuv420")),
        ("rgb", "tail", _uint8(rng, (4, 16, 64, 58, 3), dev),
         PreprocessConfig(staging_size=(64, 58), resize_short=56, crop=50)),
        ("yuv420", "tail", _uint8(rng, (4, 16, 78, 52), dev),
         PreprocessConfig(staging_size=(52, 52), resize_short=52, crop=52,
                          staging_format="yuv420")),
        ("rgb", "timesformer", _uint8(rng, (TSF_BATCH, 16, 512, 512, 3), dev),
         get_config("timesformer").preprocess),
    ]
    wrap = {"rgb": (k.preprocess_rgb, k.preprocess_rgb_plain),
            "yuv420": (k.preprocess_yuv420, k.preprocess_yuv420_plain)}
    checks, max_err = [], {"rgb": 0.0, "yuv420": 0.0}
    for lane, shape_name, x, cfg in cases:
        kernel, plain = wrap[lane]
        for out_dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, out_dtype=out_dtype)
            got = kernel(x, c)
            torch.cuda.synchronize()
            want = plain(x, c)
            assert got.shape == want.shape and got.dtype == want.dtype
            err = float((got.float() - want.float()).abs().max())
            atol = F32_ATOL if out_dtype == "float32" else BF16_ATOL[lane]
            checks.append({"kernel": lane, "shape": shape_name,
                           "input": list(x.shape), "out_dtype": out_dtype,
                           "max_abs_err": err, "atol": atol})
            if err > atol:
                raise AssertionError(f"{lane} kernel disagrees: {checks[-1]}")
            if (lane, shape_name, out_dtype) == ("rgb", "main", "bfloat16") and err:
                raise AssertionError(f"rgb kernel not bit-exact at the main shape: "
                                     f"{checks[-1]}")
            if shape_name == "main" and out_dtype == main_rgb.out_dtype:
                max_err[lane] = err

    timing = {}
    for lane, x, cfg in (("rgb", x_rgb, main_rgb), ("yuv420", x_yuv, main_yuv)):
        kernel, plain = wrap[lane]
        n = x.shape[0] * x.shape[1]
        out_values = n * cfg.crop * cfg.crop * 3
        # Input: what the function needs of each frame (the yuv420 kernel
        # reads every byte of its I420 frame); output written once.
        in_bytes = (n * rgb_input_bytes(cfg, tuple(x.shape[2:4]))
                    if lane == "rgb" else x.numel())
        nbytes = in_bytes + out_values * cfg.out_torch_dtype.itemsize
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = out_values * OPS_PER_VALUE[lane] / PEAK_FP32_FLOP_PER_S * 1e3
        # plain, kernel, kernel, plain: compare within one call, in turns.
        p1 = time_ms(lambda: plain(x, cfg), PLAIN_REPS)
        k1 = time_ms(lambda: kernel(x, cfg), KERNEL_REPS)
        k2 = time_ms(lambda: kernel(x, cfg), KERNEL_REPS)
        p2 = time_ms(lambda: plain(x, cfg), PLAIN_REPS)
        # Information: one copy_ reading and writing the same total bytes.
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = time_ms(lambda: dst.copy_(src), KERNEL_REPS)
        del src, dst
        bound = max(bytes_ms, ops_ms)
        timing[lane] = {
            "ms": min(k1, k2), "ms_runs": [k1, k2],
            "earlier_ms": PREPROCESS_EARLIER_MS[lane],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "bytes": nbytes, "input_bytes": in_bytes,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound / min(k1, k2),
            "copy_ms_info": copy_ms,
            "library_ms": None,
        }
    # Information only: F.interpolate + crop + normalize is three or more
    # PyTorch calls, so it is no single-call yardstick for the rgb kernel.
    timing["rgb"]["interp_chain_ms_info"] = time_ms(
        lambda: preprocess_clip_interp(x_rgb, main_rgb), PLAIN_REPS)
    emit({"phase": "kernels", "checks": checks, "timing": timing,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flop_per_s": PEAK_FP32_FLOP_PER_S,
                    "source": "H100 SXM data sheet"}})
    return max_err, timing


def _bf16_ulp(m: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``m``."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _mbconv_args(n, h, cin, ce, cout, seed, device):
    """x [n, h, h, cin] bf16 and folded fp32 weights at the scales of a
    trained block: fan-in normal weights, biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def t(shape, std):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32)).to(device)

    return (t((n, h, h, cin), 1.0).to(torch.bfloat16), t((cin, ce), (2 / cin) ** 0.5),
            t((ce,), 0.1), t((3, 3, ce), (2 / 9) ** 0.5), t((ce,), 0.1),
            t((ce, cout), (1 / ce) ** 0.5), t((cout,), 0.1))


def mbconv_bound(n, h, cin, ce, cout):
    """(bytes, operations, bound ms, bound_by) of one fused block: x read
    once and out written once in bf16, the fp32 weights read once; per
    pixel 2·Cin·Ce (expand) + 18·Ce (depthwise) + 2·Ce·Cout (project)."""
    pixels = n * h * h
    nbytes = pixels * (cin + cout) * 2 + 4 * (cin * ce + 11 * ce + ce * cout + cout)
    ops = pixels * (2 * cin * ce + 18 * ce + 2 * ce * cout)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_BF16_FLOP_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def phase_mbconv():
    """The fused MBConv kernels at the seven main-path shapes, 512 frames:
    bf16 x on the TF32 tensor-core kernel (the main path's, timed), fp32 x
    on the CUDA-core kernel, each against the plain version."""
    from asltpu_torch.models.mobilenetv2 import InvertedResidual
    from asltpu_torch.ops import mbconv_kernels as mb

    dev = torch.device("cuda", 0)
    n = BATCH * 16
    rows = []
    for i, (h, cin, ce, cout, count) in enumerate(MBCONV_SHAPES):
        x, *wts = _mbconv_args(n, h, cin, ce, cout, SEED + 10 + i, dev)
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            xi = x.to(dtype)
            got = mb.fused_mbconv_s1(xi, *wts)
            torch.cuda.synchronize()
            want = mb.fused_mbconv_s1_plain(xi, *wts)
            assert got.shape == want.shape == (n, h, h, cout) and got.dtype == dtype
            peak = float(want.float().abs().max())
            atol = _bf16_ulp(peak) if dtype == torch.bfloat16 else peak * MBCONV_F32_RTOL
            err = float((got.float() - want.float()).abs().max())
            errs[str(dtype).split(".")[1]] = {"path": MBCONV_PATH[dtype],
                                              "max_abs_err": err, "atol": atol,
                                              "max_abs_want": peak}
            if not err <= atol:
                raise AssertionError(f"fused_mbconv_s1 disagrees at {h}², "
                                     f"{cin}→{ce}→{cout}, {dtype}: {errs}")
            del got, want
        block = InvertedResidual(cin, cout, 1, 6).eval().to(
            device=dev, dtype=torch.bfloat16, memory_format=torch.channels_last)
        nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            p1 = time_ms(lambda: mb.fused_mbconv_s1_plain(x, *wts), MBCONV_REPS)
            k1 = time_ms(lambda: mb.fused_mbconv_s1(x, *wts), MBCONV_REPS)
            k2 = time_ms(lambda: mb.fused_mbconv_s1(x, *wts), MBCONV_REPS)
            p2 = time_ms(lambda: mb.fused_mbconv_s1_plain(x, *wts), MBCONV_REPS)
            cudnn = time_ms(lambda: block(nchw), MBCONV_REPS)
        nbytes, ops, bound, bound_by = mbconv_bound(n, h, cin, ce, cout)
        ms = min(k1, k2)
        rows.append({
            "shape": [n, h, h, cin], "ce": ce, "cout": cout,
            "launches_per_backbone": count, "path": MBCONV_PATH[torch.bfloat16],
            "tile": {"tf32_wmma": dataclasses.asdict(mb.tf32_tile_plan(h, h, cin, cout)),
                     "fp32_fma": dict(zip(("rows", "cout"), mb.tile_plan(h, h, cin, cout)))},
            "check": errs, "ms": ms, "ms_runs": [k1, k2], "earlier_ms": MBCONV_EARLIER_MS[i],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "bytes": nbytes, "operations": ops, "bound_ms": bound,
            "bound_by": bound_by, "share_of_bound": bound / ms,
            "tflops": ops / ms / 1e9, "cudnn_block_ms_info": cudnn,
        })
        del x, wts, block, nchw
        torch.cuda.empty_cache()
    weighted = {key: sum(r["launches_per_backbone"] * r[key] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms", "cudnn_block_ms_info",
                            "earlier_ms")}
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + (
            r["launches_per_backbone"] * r["bound_ms"])
    summary = {
        "launches_per_backbone": sum(r["launches_per_backbone"] for r in rows),
        **weighted, "bound_by": max(by, key=by.get), "bound_ms_by": by,
        "max_abs_err": max(r["check"]["bfloat16"]["max_abs_err"] for r in rows),
        "library_ms": None,
    }
    emit({"phase": "kernels_mbconv", "shapes": rows, "per_backbone": summary,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "bf16_flop_per_s": PEAK_BF16_FLOP_PER_S,
                    "source": "H100 SXM data sheet"}})
    return summary


def calibrate_bn(module, inputs, forward=None) -> None:
    """Set every BN's (2D and 3D) running statistics in ``module`` to those
    of one seeded batch (a train-mode pass with momentum 1 through
    ``forward``, ``module`` itself by default). At the seeded init (BN at
    identity) activations shrink through each depthwise conv of
    MobileNetV2, and the full-width features come out near 1e-8 and alike
    for every clip; I3D's grow instead; calibrated, every layer's output is
    of order 1. Every model takes ``train`` as an argument (its BN ignores
    the module's mode)."""
    bns = [m for m in module.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        (forward or module)(inputs, train=True)
    for m in bns:
        m.momentum = 0.1


def assert_norms_fp32(module) -> int:
    """Every BatchNorm2d, BatchNorm3d and LayerNorm parameter and buffer of
    ``module`` must be fp32 (as the reference keeps them under a bf16
    compute dtype); returns how many norm layers were checked."""
    from asltpu_torch.models.common import NORMS

    norms = [m for m in module.modules() if isinstance(m, NORMS)]
    bad = [(name, t.dtype) for m in norms
           for name, t in list(m.named_parameters()) + list(m.named_buffers())
           if t.is_floating_point() and t.dtype != torch.float32]
    if bad or not norms:
        raise AssertionError(f"norm layers not fp32: {bad[:5]} ({len(norms)} norms)")
    return len(norms)


def _rel_err(got, want) -> float:
    """max |got − want| over max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def phase_fused_backbone():
    """The rgb lane's batch through preprocess → fused backbone → GRU head,
    against ``predict``; then layer by layer with calibrated BN; then the
    times. Returns the launch counts of the main-path run."""
    import copy

    from asltpu_torch import api
    from asltpu_torch.models.mobilenet_fused import fused_backbone_apply, fused_layers
    from asltpu_torch.models.temporal import GRUHead
    from asltpu_torch.ops import mbconv_kernels as mb
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.ops.preprocess import preprocess_clip

    model = api.load_model("mobilenet_gru", seed=SEED)
    cfg, module = model.cfg, model.module
    assert cfg.width_mult == 1.0 and cfg.gru_hidden == 512
    assert cfg.num_classes == 100 and cfg.preprocess.crop == 224
    t = cfg.preprocess.num_frames
    staged = cfg.preprocess.staged_frame_shape
    frames = np.random.default_rng(SEED + 1).integers(0, 256, (BATCH, t, *staged), np.uint8)
    x = torch.from_numpy(frames).to(model.device)

    def fused_predict():
        with torch.inference_mode():
            clip = preprocess_clip(x, cfg.preprocess)
            feats = fused_backbone_apply(module.features, clip.flatten(0, 1))
            return feats, GRUHead.forward(module, feats.reshape(BATCH, t, -1))

    def head_logits(feats):
        with torch.inference_mode():
            return GRUHead.forward(module, feats.reshape(BATCH, t, -1))

    # 1. The main path at load_model's weights, against predict.
    torch.cuda.synchronize()
    k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
    mb.fused_mbconv_s1.launches = 0
    feats, logits = fused_predict()
    torch.cuda.synchronize()
    launches = {"preprocess_rgb": k.preprocess_rgb.launches,
                "preprocess_yuv420": k.preprocess_yuv420.launches,
                "fused_mbconv_s1": mb.fused_mbconv_s1.launches}
    if launches != {"preprocess_rgb": 1, "preprocess_yuv420": 0, "fused_mbconv_s1": 12}:
        raise AssertionError(f"fused path launches: {launches}")
    with torch.inference_mode():
        nhwc = preprocess_clip(x, cfg.preprocess).flatten(0, 1)
        nchw = nhwc.permute(0, 3, 1, 2)
        want_feats = module.features(nchw)
        want_logits = model.predict_fn()(x)
    assert feats.shape == want_feats.shape == (BATCH * t, 1280)
    assert logits.shape == want_logits.shape == (BATCH, 100)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(feats).all())
    feat_err = _rel_err(feats, want_feats)
    logit_err = float((logits - want_logits).abs().max())
    ids, want_ids = logits.argmax(-1), want_logits.argmax(-1)
    top2 = want_logits.sort(dim=-1).values
    if (feat_err > FEATURE_RTOL or logit_err > FUSED_LOGIT_ATOL
            or not bool((ids == want_ids).all())):
        raise AssertionError(
            f"fused backbone disagrees with predict: features {feat_err} of the "
            f"largest, logits {logit_err}, top-1 {ids.tolist()} vs {want_ids.tolist()}")
    seeded = {
        "max_feature_rel_err": feat_err, "feature_rtol": FEATURE_RTOL,
        "max_abs_feature": float(want_feats.float().abs().max()),
        "max_logit_err_vs_predict": logit_err, "logit_atol": FUSED_LOGIT_ATOL,
        "top1_equal_predict": True,
        "min_top1_margin": float((top2[:, -1] - top2[:, -2]).min()),
        "distinct_top1": len(set(want_ids.tolist())),
    }

    # 2. BN calibrated on a seeded batch: each of the 19 layers of the fused
    # path against the module's own layer on the same input. Whole-backbone
    # outputs are no test here: with unit-variance BN the random net
    # amplifies rounding chaotically (step 3).
    calib = np.random.default_rng(SEED + 2).integers(0, 256, (8, t, *staged), np.uint8)
    with torch.inference_mode():
        calib = preprocess_clip(torch.from_numpy(calib).to(model.device), cfg.preprocess)
    calibrate_bn(module.features, calib.flatten(0, 1).permute(0, 3, 1, 2))
    per_layer = []
    with torch.inference_mode():
        y = nhwc
        for i, layer in enumerate(fused_layers(module.features)):
            want = module.features[i](y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            y = layer(y)
            per_layer.append(_rel_err(y, want))
            peak = float(want.float().abs().max())
            if per_layer[-1] > FEATURE_RTOL or peak < 0.1:
                raise AssertionError(f"fused layer {i} disagrees with the module's: "
                                     f"{per_layer[-1]} of the largest ({peak})")
            del want

    # 3. Information: with calibrated BN, both bf16 backbones against the
    # same weights in fp32 (TF32 off), features and top-1 through the head.
    with torch.inference_mode():
        f32 = copy.deepcopy(module.features).float()
        ref = f32(nchw.float())
        del f32
        fused_f = fused_backbone_apply(module.features, nhwc)
        cudnn_f = module.features(nchw)
        ref_ids = head_logits(ref).argmax(-1)
        calibrated = {
            "fused_feature_rel_err_vs_fp32": _rel_err(fused_f, ref),
            "cudnn_bf16_feature_rel_err_vs_fp32": _rel_err(cudnn_f, ref),
            "fused_vs_cudnn_feature_rel_err": _rel_err(fused_f, cudnn_f),
            "fused_top1_equal_fp32": int((head_logits(fused_f).argmax(-1) == ref_ids).sum()),
            "cudnn_top1_equal_fp32": int((head_logits(cudnn_f).argmax(-1) == ref_ids).sum()),
            "distinct_top1_fp32": len(set(ref_ids.tolist())),
        }
        del ref, fused_f, cudnn_f
    torch.cuda.empty_cache()

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    with torch.inference_mode():
        # cuDNN, fused, fused, cuDNN: compare within one call, in turns.
        c1 = time_ms(lambda: module.features(nchw), PREDICT_REPS)
        f1 = time_ms(lambda: fused_backbone_apply(module.features, nhwc), PREDICT_REPS)
        f2 = time_ms(lambda: fused_backbone_apply(module.features, nhwc), PREDICT_REPS)
        c2 = time_ms(lambda: module.features(nchw), PREDICT_REPS)
        predict_fn = model.predict_fn()
        fused_predict_ms = time_ms(fused_predict, PREDICT_REPS)
        predict_ms = time_ms(lambda: predict_fn(x), PREDICT_REPS)
    emit({
        "phase": "fused_backbone", "input": list(frames.shape),
        "launches": launches, "seeded_weights": seeded,
        "calibrated_per_layer_rel_err": per_layer, "layer_rtol": FEATURE_RTOL,
        "calibrated_vs_fp32_info": calibrated,
        "fused_backbone_ms": min(f1, f2), "fused_backbone_ms_runs": [f1, f2],
        "cudnn_backbone_ms": min(c1, c2), "cudnn_backbone_ms_runs": [c1, c2],
        "fused_predict_ms": fused_predict_ms, "predict_ms": predict_ms,
        "fused_backbone_peak_gb": peak_gb(lambda: fused_backbone_apply(
            module.features, nhwc)),
        "cudnn_backbone_peak_gb": peak_gb(lambda: module.features(nchw)),
    })
    return launches


def _varied_clips(seed, batch, t, staged_shape):
    """uint8 clips of smooth moving patterns, as ``write_video`` draws them,
    with a phase, frequency, direction, brightness and contrast of their
    own, staged as RGB ``[B, T, H, W, 3]`` or packed I420 ``[B, T, H·3/2,
    W]`` (the Y plane, then the U and V planes at half resolution). i.i.d.
    noise would pool to nearly the same features for every clip."""
    rgb = len(staged_shape) == 3
    h, w = staged_shape[:2] if rgb else (staged_shape[0] * 2 // 3, staged_shape[1])
    rng = np.random.default_rng(seed)
    out = np.empty((batch, t, *staged_shape), np.uint8)
    tt = np.arange(t, dtype=np.float32)[:, None, None, None]

    def pattern(hh, ww, step, p):
        yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32) * step
        ramp = (np.cos(p["theta"]) * xx + np.sin(p["theta"]) * yy)[None, :, :, None]
        img = p["level"] + p["amp"] * np.sin(p["freq"] * ramp + p["phase"] + 0.3 * tt)
        return np.clip(img, 0, 255).astype(np.uint8)

    for b in range(batch):
        p = {"phase": rng.uniform(0, 2 * np.pi, 3), "freq": rng.uniform(0.02, 0.08, 3),
             "theta": rng.uniform(0, np.pi), "level": rng.uniform(70, 185),
             "amp": rng.uniform(30, 70)}
        if rgb:
            out[b] = pattern(h, w, 1, p)
        else:
            y = pattern(h, w, 1, p)[..., 0].reshape(t, -1)
            uv = pattern(h // 2, w // 2, 2, p)
            out[b] = np.concatenate([y, uv[..., 1].reshape(t, -1),
                                     uv[..., 2].reshape(t, -1)], 1).reshape(t, *staged_shape)
    return out


def _landmarks(model, batch, seed):
    """Seeded landmarks [batch, T, 543, 3] for a model that takes them,
    else None."""
    from asltpu_torch.data.synthetic import synthetic_landmarks

    if not model.takes_landmarks:
        return None
    return synthetic_landmarks(batch, model.cfg.preprocess.num_frames, seed=seed)


def _lane_varied(family, pp_overrides, staged_shape):
    """Kernel vs plain preprocess on logits that vary: an fp32 model (fp32
    preprocess out, TF32 off) with BN calibrated on a seeded batch through
    its backbone (every BN of each family sits there), its state copied
    into the ``use_pallas=False`` twin, both fed clips (and landmarks) that
    differ from clip to clip. Returns the comparison's numbers; raises when
    the logits barely vary or the two disagree."""
    from asltpu_torch import api
    from asltpu_torch.benchmark import backbone_and_head
    from asltpu_torch.ops.preprocess import preprocess_clip

    batch = FAMILIES[family]["batch"]
    pp = dict(pp_overrides, out_dtype="float32")
    model = api.load_model(family, seed=SEED, compute_dtype="float32", preprocess=pp)
    t = model.cfg.preprocess.num_frames
    calib = torch.from_numpy(_varied_clips(SEED + 3, 8, t, staged_shape)).to(model.device)
    with torch.inference_mode():
        calib = preprocess_clip(calib, model.cfg.preprocess)
    backbone, _ = backbone_and_head(model.module)
    calibrate_bn(model.module, calib, backbone)
    del calib
    plain = api.load_model(family, seed=SEED, compute_dtype="float32",
                           preprocess=dict(pp, use_pallas=False))
    plain.module.load_state_dict(model.module.state_dict())
    frames = _varied_clips(SEED + 4, batch, t, staged_shape)
    lm = _landmarks(model, batch, SEED + 5)
    ids, logits = api.predict(model, frames, lm)
    plain_ids, plain_logits = api.predict(plain, frames, lm)
    del model, plain
    torch.cuda.empty_cache()
    spread = float(np.abs(plain_logits - plain_logits.mean(0)).max())
    err = float(np.abs(logits - plain_logits).max())
    top2 = np.sort(plain_logits, axis=-1)
    margin = top2[:, -1] - top2[:, -2]
    covered = margin > 2 * err
    result = {
        "compute_dtype": "float32", "bn": "calibrated", "logit_spread": spread,
        "spread_min": VARIED_SPREAD_MIN, "max_logit_err_vs_plain": err,
        "err_rtol_of_spread": VARIED_ERR_RTOL,
        "distinct_top1": len(set(plain_ids.tolist())),
        "min_top1_margin": float(margin.min()),
        "top1_rule_clips": int(covered.sum()),
    }
    if (spread < VARIED_SPREAD_MIN or err > VARIED_ERR_RTOL * spread
            or not (ids[covered] == plain_ids[covered]).all()):
        raise AssertionError(f"kernel vs plain preprocess on varied clips: {result}, "
                             f"top-1 {ids.tolist()} vs {plain_ids.tolist()}")
    return result


def _lane(name, family, pp_overrides, staged_shape):
    """Drive one lane of one family through the public API; returns the
    launch counts of the main-path predict."""
    from asltpu_torch import api
    from asltpu_torch.benchmark import stage_fns
    from asltpu_torch.ops import preprocess_kernels as k

    batch = FAMILIES[family]["batch"]
    model = api.load_model(family, seed=SEED, preprocess=dict(pp_overrides))
    cfg = model.cfg
    for key, want in FAMILIES[family]["config"].items():
        assert getattr(cfg, key) == want, (family, key, getattr(cfg, key))
    assert cfg.preprocess.crop == 224 and cfg.compute_dtype == "bfloat16"
    norms = assert_norms_fp32(model.module)
    frames = np.random.default_rng(SEED + 1).integers(
        0, 256, (batch, cfg.preprocess.num_frames, *staged_shape), np.uint8)
    assert frames.shape[2:] == cfg.preprocess.staged_frame_shape
    lm = _landmarks(model, batch, SEED + 2)
    torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    k.preprocess_rgb.launches = 0
    k.preprocess_yuv420.launches = 0
    reset_pool_launches()
    ids, logits = api.predict(model, frames, lm)
    torch.cuda.synchronize()
    pools = pool_launches()
    launches = {"preprocess_rgb": k.preprocess_rgb.launches,
                "preprocess_yuv420": k.preprocess_yuv420.launches,
                "max_pool3d_same": pools[0], "max_pool3d_same_backward": pools[1]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_pools = [I3D_POOLS if family == "i3d" else 0, 0]
    if pools != want_pools:
        raise AssertionError(f"{name} lane: max-pool launches {pools}, want {want_pools}")

    assert logits.shape == (batch, cfg.num_classes) and np.isfinite(logits).all()
    plain_model = api.load_model(
        family, seed=SEED, preprocess=dict(pp_overrides, use_pallas=False))
    assert_norms_fp32(plain_model.module)
    plain_ids, plain_logits = api.predict(plain_model, frames, lm)
    err = float(np.abs(logits - plain_logits).max())
    top2 = np.sort(plain_logits, axis=-1)
    if not (ids == plain_ids).all() or err > LANE_LOGIT_ATOL:
        raise AssertionError(f"{name} lane: kernel and plain preprocess disagree "
                             f"(max logit err {err}, top-1 {ids} vs {plain_ids})")
    varied = _lane_varied(family, pp_overrides, staged_shape)

    xs = [torch.from_numpy(a).to(model.device) for a in (frames, lm) if a is not None]
    fn, plain_fn = model.predict_fn(), plain_model.predict_fn()
    ms = time_ms(lambda: fn(*xs), PREDICT_REPS)
    plain_ms = time_ms(lambda: plain_fn(*xs), PREDICT_REPS)
    pool_turns = None
    if family == "i3d":
        # The same predict with aten's pools in place of the kernels, in
        # turns: kernels, aten, aten, kernels.
        pool_turns = {"kernels": [], "aten": []}
        for which in ("kernels", "aten", "aten", "kernels"):
            with _aten_pools() if which == "aten" else contextlib.nullcontext():
                pool_turns[which].append(time_ms(lambda: fn(*xs), PREDICT_REPS))
    # The same predict, stage by stage: preprocess, backbone, head.
    with torch.inference_mode():
        split = {stage: time_ms(f, KERNEL_REPS if stage == "preprocess" else PREDICT_REPS)
                 for stage, f in stage_fns(model, *xs).items()}
    emit({
        "phase": f"{name}_lane", "family": family,
        "config": {"preprocess": pp_overrides, "compute_dtype": cfg.compute_dtype},
        "input": list(frames.shape),
        "landmarks_input": None if lm is None else list(lm.shape), "launches": launches,
        "norm_layers_fp32": norms,
        "logits_finite": True, "top1_equal_plain": True,
        "max_logit_err_vs_plain": err, "atol": LANE_LOGIT_ATOL,
        "min_top1_margin": float((top2[:, -1] - top2[:, -2]).min()),
        "distinct_top1": len(set(plain_ids.tolist())), "varied_clips": varied,
        "device_ms_per_batch": ms, "device_clips_per_s": batch / ms * 1e3,
        "plain_device_ms_per_batch": plain_ms,
        "plain_device_clips_per_s": batch / plain_ms * 1e3,
        "stage_ms": split, "peak_mem_gb": peak_gb,
        **({} if pool_turns is None else {
            "device_ms_per_batch_pool_kernels": min(pool_turns["kernels"]),
            "device_ms_per_batch_aten_pools": min(pool_turns["aten"]),
            "pool_ms_in_turns": pool_turns}),
    })
    del model, plain_model, xs
    torch.cuda.empty_cache()
    return launches


def phase_stem():
    """I3D's stem conv in its two forms at the contract shape, bf16: the
    plain strided conv against the space-to-depth rewrite (one bf16 ulp of
    the largest output), both timed in turns beside the bound: the
    multiply-adds of the plain form (7³·3 per output value; the rewrite
    adds zero taps) at the bf16 tensor-core peak, or x, w and out once."""
    from asltpu_torch.models import i3d
    from asltpu_torch.ops import stem_s2d as st

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    b, t, h, w, c = STEM_SHAPE
    x = torch.randn(STEM_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    x = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d memory
    wt = (torch.randn((STEM_COUT, c, 7, 7, 7), generator=gen, device=dev)
          / (c * 343) ** 0.5).to(torch.bfloat16).contiguous(
              memory_format=torch.channels_last_3d)
    with torch.inference_mode():
        plain = st.stem_conv3d_plain(x, wt)
        s2d = st.stem_conv3d_s2d(x, wt)
        model_form = i3d.stem_conv(x, wt)
    torch.cuda.synchronize()
    out_shape = (b, STEM_COUT, t // 2, h // 2, w // 2)
    assert plain.shape == s2d.shape == out_shape, (plain.shape, s2d.shape)
    peak = float(plain.float().abs().max())
    err = float((s2d.float() - plain.float()).abs().max())
    atol = _bf16_ulp(peak)
    if not err <= atol:
        raise AssertionError(f"stem forms disagree: {err} > one bf16 ulp {atol} of {peak}")
    runs = {"plain": [], "s2d": []}
    with torch.inference_mode():
        for form in ("plain", "s2d", "s2d", "plain"):
            fn = st.stem_conv3d_plain if form == "plain" else st.stem_conv3d_s2d
            runs[form].append(time_ms(lambda: fn(x, wt), STEM_REPS))
    n_out = int(np.prod(out_shape))
    ops = 2 * n_out * c * 343
    nbytes = 2 * (x.numel() + wt.numel() + n_out)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_FLOP_PER_S * 1e3
    ms = {form: min(r) for form, r in runs.items()}
    result = {
        "phase": "stem", "input": list(STEM_SHAPE), "dtype": "bfloat16",
        "output": list(out_shape), "max_abs_err_s2d_vs_plain": err, "atol": atol,
        "max_abs_out": peak, "ms": ms, "ms_runs": runs,
        "faster": min(ms, key=ms.get),
        "model_form": ("plain" if torch.equal(model_form, plain) else
                       "s2d" if torch.equal(model_form, s2d) else "neither bit-equal"),
        "operations": ops, "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    result["share_of_bound"] = {f: result["bound_ms"] / v for f, v in ms.items()}
    emit(result)
    del x, wt, plain, s2d, model_form
    torch.cuda.empty_cache()
    return result


# Phase pool3d: I3D's 13 max-pools at the fine-tune's batch (module
# docstring, phase 20): their shapes from the model itself (a backbone on the
# meta device), the kernels against the plain version, timed beside aten.
POOL_BATCH = 48
POOL_REPS = 5
# Small shapes for the other access widths: C = 132 (a tensor-parallel
# shard: 8 bytes a thread in bf16) and fp32 (16 bytes).
POOL_TAILS = (
    ("c132", (4, 132, 9, 14, 13), (3, 3, 3), (2, 2, 2), torch.bfloat16),
    ("fp32", (4, 192, 8, 14, 14), (3, 3, 3), (1, 1, 1), torch.float32),
)
# The I3D step with the kernels against the same step with aten's pools
# (batch 2, 64 frames of 256² staged): the forward is bit-identical, so
# the losses agree as far as cuDNN's convolutions repeat themselves; the
# gradients differ by cuDNN's backward and the pools' rounding.
POOL_STEP_BATCH = 2


def _i3d_pools(batch):
    """(input shape, kernel, stride, pad) of each pool call of full-width
    I3D's backbone on [batch, 64, 224, 224, 3], traced on the meta device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from asltpu_torch.models import i3d

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.pools = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func) == "asltpu_torch.max_pool3d_same.default":
                self.pools.append((tuple(args[0].shape), *(tuple(a) for a in args[1:4])))
            return func(*args, **(kwargs or {}))

    with torch.device("meta"):
        model = i3d.I3D(num_classes=FAMILIES["i3d"]["config"]["num_classes"], remat=False,
                        dtype=torch.bfloat16)
        with Calls() as calls, torch.no_grad():
            model.backbone(torch.empty(batch, FAMILIES["i3d"]["config"]["num_frames"],
                                       224, 224, 3))
    return calls.pools


def _aten_pool(x, kernel, stride, pad):
    """What I3D ran before the op: the −inf copy of the upper pads' excess
    (``pad_same``), then aten's ``max_pool3d`` with int64 indices (as
    autograd records it). Returns (out, indices, the padded input, the
    symmetric padding)."""
    import torch.nn.functional as F

    extra = []
    for lo, hi in reversed(list(zip(pad[0::2], pad[1::2]))):
        extra += [0, hi - lo]
    padded = F.pad(x, extra, value=float("-inf")) if any(extra) else x
    out, idx = torch.ops.aten.max_pool3d_with_indices(padded, kernel, stride, pad[0::2])
    return out, idx, padded, pad[0::2]


def _bf16_ulps_apart(got, want) -> float:
    """The largest |got − want| in bf16 ulps of the larger magnitude of the
    two, element by element (0 where both are 0)."""
    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.ones_like(m))
    return float(((g - w).abs() / ulp).max())


def _pool_case(x, kernel, stride, pad, timed):
    """One pool on the card: the kernels' forward against aten's bit for
    bit and their offsets against the plain version's; their input gradient
    within one bf16 ulp of aten's taken in fp32 and rounded once (aten's own
    in the working dtype beside it, as information); with ``timed`` both
    directions of both by CUDA events, beside their bounds."""
    from asltpu_torch.ops import pool3d_kernels as pk

    size = list(x.shape[2:])
    out, off = torch.ops.asltpu_torch.max_pool3d_same.default(x, kernel, stride, pad)
    torch.cuda.synchronize()
    want, _, _, _ = _aten_pool(x, kernel, stride, pad)
    int_view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    row = {"input": list(x.shape), "dtype": str(x.dtype).split(".")[1],
           "kernel": list(kernel), "stride": list(stride), "pad": list(pad),
           "forward_bit_identical": bool(torch.equal(out.view(int_view), want.view(int_view))),
           "offsets_equal": bool(torch.equal(off, pk.max_pool3d_plain(x, kernel, stride,
                                                                        pad)[1]))}
    del want
    gen = torch.Generator(x.device).manual_seed(SEED + 41)
    g = torch.randn(out.shape, generator=gen, device=x.device).to(x.dtype).contiguous(
        memory_format=torch.channels_last_3d)
    got = pk.max_pool3d_same_backward(g, off, size, kernel, stride, pad)
    xf = x.float().requires_grad_()
    (exact,) = torch.autograd.grad(_aten_pool(xf, kernel, stride, pad)[0], xf, g.float())
    row["grad_ulps_vs_fp32"] = _bf16_ulps_apart(got, exact.to(x.dtype)) if (
        x.dtype == torch.bfloat16) else float((got - exact).abs().max())
    del xf, exact
    xg = x.detach().requires_grad_()
    (aten_grad,) = torch.autograd.grad(_aten_pool(xg, kernel, stride, pad)[0], xg, g)
    if x.dtype == torch.bfloat16:
        row["aten_grad_ulps_vs_kernel_info"] = _bf16_ulps_apart(aten_grad, got)
    del xg, aten_grad, got
    if not (row["forward_bit_identical"] and row["offsets_equal"]):
        raise AssertionError(f"max_pool3d_same forward disagrees with aten's: {row}")
    bound = 1.0 if x.dtype == torch.bfloat16 else 1e-5
    if not row["grad_ulps_vs_fp32"] <= bound:
        raise AssertionError(f"max_pool3d_same backward disagrees: {row}")
    if timed:
        def aten_forward():
            return _aten_pool(x, kernel, stride, pad)

        _, idx, padded, sym = aten_forward()

        def aten_backward():
            return torch.ops.aten.max_pool3d_with_indices_backward(
                g, padded, kernel, stride, sym, [1, 1, 1], False, idx)

        def kernel_forward():
            return torch.ops.asltpu_torch.max_pool3d_same.default(x, kernel, stride, pad)

        def kernel_backward():
            return pk.max_pool3d_same_backward(g, off, size, kernel, stride, pad)

        ms = {}
        for name, fn in (("library_fwd", aten_forward), ("fwd", kernel_forward),
                         ("fwd", kernel_forward), ("library_fwd", aten_forward),
                         ("library_bwd", aten_backward), ("bwd", kernel_backward),
                         ("bwd", kernel_backward), ("library_bwd", aten_backward)):
            ms.setdefault(name, []).append(time_ms(fn, POOL_REPS))
        del idx, padded
        item = x.element_size()
        fwd_bytes = x.numel() * item + out.numel() * (item + 1)
        bwd_bytes = out.numel() * (item + 1) + x.numel() * item
        row.update({
            "ms_fwd": min(ms["fwd"]), "ms_bwd": min(ms["bwd"]),
            "library_ms_fwd": min(ms["library_fwd"]), "library_ms_bwd": min(ms["library_bwd"]),
            "ms_runs": ms, "bytes_fwd": fwd_bytes, "bytes_bwd": bwd_bytes,
            "bound_ms_fwd": fwd_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_ms_bwd": bwd_bytes / PEAK_BYTES_PER_S * 1e3,
        })
        row["share_of_bound"] = ((row["bound_ms_fwd"] + row["bound_ms_bwd"])
                                 / (row["ms_fwd"] + row["ms_bwd"]))
    return row


@contextlib.contextmanager
def _aten_pools():
    """I3D's pools through aten (``_aten_pool``'s forward, autograd's
    backward) instead of the op, for the step comparison."""
    from asltpu_torch.models import i3d

    saved = i3d.max_pool3d_same
    i3d.max_pool3d_same = lambda x, kernel, stride, pad: _aten_pool(
        x, list(kernel), list(stride), list(pad))[0]
    try:
        yield
    finally:
        i3d.max_pool3d_same = saved


def _pool_step(remat, aten):
    """One I3D train step (lr 0, the first of a warmup) at POOL_STEP_BATCH:
    (loss, grad_norm, forward and backward kernel launches)."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.ops import pool3d_kernels as pk
    from asltpu_torch.train import loop

    model = api.build_trainable("i3d", seed=SEED, remat=remat)
    tcfg = TrainConfig()
    state = loop.create_train_state(model.module, tcfg, SEED)
    pp = model.cfg.preprocess
    batch, labels = next(SeededBatches(
        (POOL_STEP_BATCH, pp.num_frames, *pp.staged_frame_shape), model.cfg.num_classes,
        model.device, seed=SEED + 42))
    step = loop.make_step_fn(tcfg, pp)
    with _aten_pools() if aten else contextlib.nullcontext():
        pk.max_pool3d_same.launches = pk.max_pool3d_same_backward.launches = 0
        state, metrics = step(state, batch, labels)
        torch.cuda.synchronize()
    launches = [pk.max_pool3d_same.launches, pk.max_pool3d_same_backward.launches]
    del model, state
    torch.cuda.empty_cache()
    return float(metrics["loss"]), float(metrics["grad_norm"]), launches


def phase_pool3d():
    """I3D's max-pools on the card (module docstring, phase 20): each of the
    13 main-path pools at the fine-tune's batch, checked and timed; the
    narrower accesses at small shapes; one I3D train step with the kernels
    against aten's pools, with the launches a step. Returns the summary."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(SEED + 40)
    rows = []
    for i, (shape, kernel, stride, pad) in enumerate(_i3d_pools(POOL_BATCH)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        x[0, :, :3, :3, :3] = 1.5  # all-equal windows: the first maximum
        x[1, :, 1, 1, 1] = float("nan")
        rows.append({"pool": i, **_pool_case(x, list(kernel), list(stride), list(pad), True)})
        del x
        torch.cuda.empty_cache()
    tails = []
    for name, shape, kernel, stride, dtype in POOL_TAILS:
        from asltpu_torch.models.common import same_pads

        pad = [p for lo_hi in same_pads(shape[2:], kernel, stride) for p in lo_hi]
        x = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
            memory_format=torch.channels_last_3d)
        tails.append({"case": name, **_pool_case(x, list(kernel), list(stride), pad, False)})
    # What no access width fits: C = 3, and a view one value off alignment.
    n, c, t, h, w = 2, 64, 6, 9, 9
    flat = torch.randn(n * t * h * w * c + 1, generator=gen, device=dev).to(torch.bfloat16)
    refused = {}
    for case, x in (("c3", torch.zeros(2, 3, 8, 15, 15, dtype=torch.bfloat16, device=dev)
                     .contiguous(memory_format=torch.channels_last_3d)),
                    ("unaligned", flat[1:].view(n, t, h, w, c).permute(0, 4, 1, 2, 3))):
        before = pool_launches()
        try:
            torch.ops.asltpu_torch.max_pool3d_same.default(x, [3, 3, 3], [1, 1, 1], [1] * 6)
        except ValueError as e:
            refused[case] = str(e)
        if case not in refused or pool_launches() != before:
            raise AssertionError(f"pool3d: the {case} input was not refused")
    steps = {}
    for remat in (False, True):
        k_loss, k_norm, k_launches = _pool_step(remat, aten=False)
        a_loss, a_norm, a_launches = _pool_step(remat, aten=True)
        steps["remat" if remat else "no_remat"] = {
            "launches_fwd_bwd": k_launches, "aten_launches": a_launches,
            "loss": k_loss, "loss_rel_err_vs_aten": abs(k_loss - a_loss) / abs(a_loss),
            "grad_norm": k_norm, "grad_norm_rel_err_vs_aten": abs(k_norm - a_norm) / a_norm}
    want_launches = {"no_remat": [13, 13], "remat": [13 + 9, 13]}
    for key, st in steps.items():
        if st["launches_fwd_bwd"] != want_launches[key] or st["aten_launches"] != [0, 0]:
            raise AssertionError(f"pool3d: launches a step {st}, want {want_launches[key]}")
        if (st["loss_rel_err_vs_aten"] > TRAIN_PLAIN_LOSS_RTOL
                or st["grad_norm_rel_err_vs_aten"] > TRAIN_PLAIN_GRAD_RTOL):
            raise AssertionError(f"pool3d: the step with the kernels disagrees: {st}")
    summary = {key: sum(r[key] for r in rows) for key in (
        "ms_fwd", "ms_bwd", "library_ms_fwd", "library_ms_bwd", "bound_ms_fwd", "bound_ms_bwd")}
    summary["share_of_bound"] = ((summary["bound_ms_fwd"] + summary["bound_ms_bwd"])
                                 / (summary["ms_fwd"] + summary["ms_bwd"]))
    summary["max_grad_ulps"] = max(r["grad_ulps_vs_fp32"] for r in rows)
    emit({"phase": "pool3d", "batch": POOL_BATCH, "pools": rows, "tails": tails,
          "refused": refused, "steps": steps, "per_step": summary,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S, "source": "H100 SXM data sheet"}})
    return summary


def phase_host():
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        emit({"phase": "host", "ran": False,
              "why": f"OpenCV is not installed on this machine ({e})"})
        return
    from asltpu_torch import api
    from asltpu_torch.data.synthetic import write_video

    model = api.load_model("mobilenet_gru", seed=SEED)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, size in enumerate([(240, 320), (320, 240), (256, 256), (480, 640)]):
            paths.append(os.path.join(d, f"clip{i}.mp4"))
            write_video(paths[-1], num_frames=40, size=size, seed=i)
        singles = []
        for p in paths:
            clip = api.load_clip(p, model.cfg.preprocess)
            assert clip.shape == (16, 256, 256, 3)
            _, logits = api.predict(model, clip)
            assert logits.shape == (100,) and np.isfinite(logits).all()
            singles.append(logits)
        out = list(api.stream_predict(model, paths, batch_size=2,
                                      num_decode_workers=2, decode_backend="thread"))
    assert [p for p, _, _ in out] == paths
    err = max(float(np.abs(lg - s).max()) for (_, _, lg), s in zip(out, singles))
    if err > 5e-2:
        raise AssertionError(f"stream_predict disagrees with predict by {err}")
    emit({"phase": "host", "ran": True, "clips": len(paths),
          "max_logit_err_stream_vs_predict": err})


def _mad(a, b) -> float:
    return float(np.mean(np.abs(a.astype(np.int32) - b.astype(np.int32))))


def _system_opencv_version(include_dir: str):
    """CV_VERSION of the OpenCV C++ headers the native library builds with."""
    import re

    try:
        with open(os.path.join(include_dir, "opencv2", "core", "version.hpp")) as f:
            text = f.read()
    except OSError:
        return None
    parts = [re.search(rf"#define CV_VERSION_{k}\s+(\d+)", text) for k in
             ("MAJOR", "MINOR", "REVISION")]
    return ".".join(m.group(1) for m in parts if m)


def phase_decode_backends():
    """The native decode libraries against the cv2 path, then
    ``stream_predict(decode_backend="auto")`` against ``predict``."""
    try:
        import cv2
    except ImportError as e:
        emit({"phase": "decode_backends", "ran": False,
              "why": f"OpenCV (cv2) is not installed on this machine ({e})"})
        return
    from asltpu_torch import api, native
    from asltpu_torch.config import PreprocessConfig
    from asltpu_torch.data import decode
    from asltpu_torch.data.synthetic import write_video
    from asltpu_torch.data.wlasl import ClipRecord

    ffmpeg = [ln.strip() for ln in cv2.getBuildInformation().splitlines()
              if "FFMPEG" in ln or "avcodec" in ln]
    lanes = {"rgb": PreprocessConfig(), "yuv420": PreprocessConfig(**YUV_LANE)}
    libs = {}
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, size in enumerate([(240, 320), (320, 240), (256, 256), (480, 640)]):
            paths.append(os.path.join(d, f"fresh{i}.mp4"))
            write_video(paths[-1], num_frames=40, size=size, seed=100 + i)
        rec = ClipRecord("seg", "gloss", 0, "test", paths[3], frame_start=6,
                         frame_end=33, bbox=(60, 30, 560, 470))
        items = paths + [rec]

        def cv2_path(pp):
            return np.stack([decode.decode_sampled_frames(
                getattr(it, "path", it), pp.num_frames, pp.staging_size,
                pp.host_resize_short, frame_start=getattr(it, "frame_start", 1),
                frame_end=getattr(it, "frame_end", -1), bbox=getattr(it, "bbox", None),
                staging_format=pp.staging_format) for it in items])

        for lib in ("opencv", "av"):
            spec = native.SPECS[lib]
            missing = native.toolchain_missing(lib)
            if missing:
                libs[lib] = {"ran": False, "why": missing}
                continue
            t0 = time.perf_counter()
            path = native.build(lib)  # raises, naming the log, if g++ fails
            build_s = time.perf_counter() - t0
            reason = (native.unavailable_reason() if lib == "opencv"
                      else native.av_unavailable_reason())
            if reason:
                raise RuntimeError(f"native {lib} does not load: {reason}")
            row = {"ran": True, "library": str(path.relative_to(path.parents[2])),
                   "include_dir": native._include_dir(spec), "build_s": build_s,
                   "lanes": {}}
            if lib == "opencv":
                row["system_opencv"] = _system_opencv_version(row["include_dir"])
            for lane, pp in lanes.items():
                want = cv2_path(pp)
                yuv = pp.staging_format == "yuv420"
                if lib == "opencv":
                    got, ok = native.decode_batch_native(
                        items, pp.num_frames, pp.staging_size, pp.host_resize_short,
                        yuv420=yuv)
                    differ = int((got != want).sum())
                    row["lanes"][lane] = {"shape": list(got.shape), "ok": ok.tolist(),
                                          "bytes_differing": differ}
                    if ok.any() or differ:
                        raise AssertionError(
                            f"native OpenCV decode differs from the cv2 path ({lane}): "
                            f"{row}; python cv2 {cv2.__version__} {ffmpeg}")
                else:
                    got, ok = native.decode_batch_av(
                        items, pp.num_frames, pp.staging_size, pp.host_resize_short,
                        yuv420=yuv)
                    fast, fok = native.decode_batch_av(
                        items, pp.num_frames, pp.staging_size, pp.host_resize_short,
                        yuv420=yuv, fast_flags=native.FAST_ALL)
                    mads = [_mad(got[i], want[i]) for i in range(len(items))]
                    fast_mads = [_mad(fast[i], want[i]) for i in range(len(items))]
                    bounds = [AV_BBOX_MAD if getattr(it, "bbox", None) else AV_MAD
                              for it in items]
                    row["lanes"][lane] = {"ok": ok.tolist(), "mad": mads,
                                          "mad_bounds": bounds, "mad_fast_all": fast_mads,
                                          "fast_bound": AV_FAST_MAD}
                    if (ok.any() or fok.any() or any(m > b for m, b in zip(mads, bounds))
                            or max(fast_mads) > AV_FAST_MAD):
                        raise AssertionError(f"av decode off the cv2 path ({lane}): {row}")
            libs[lib] = row

        model = api.load_model("mobilenet_gru", seed=SEED)
        pp = model.cfg.preprocess
        pool = decode.make_decode_pool(pp)
        chosen = pool.backend
        pool.shutdown()
        out = list(api.stream_predict(model, items, batch_size=len(items),
                                      num_decode_workers=4, decode_backend="auto",
                                      yield_items=True))
        ids, logits = api.predict(model, cv2_path(pp))
    got = np.stack([lg for _, _, lg in out])
    err = float(np.abs(got - logits).max())
    if [it for it, _, _ in out] != items or not (got.argmax(-1) == ids).all() \
            or err > LANE_LOGIT_ATOL:
        raise AssertionError(f"stream_predict(auto, {chosen}) disagrees with predict: "
                             f"max logit err {err}")
    emit({"phase": "decode_backends", "ran": True, "python_cv2": cv2.__version__,
          "python_cv2_video_io": ffmpeg, "items": len(items),
          "record": {"frame_start": rec.frame_start, "frame_end": rec.frame_end,
                     "bbox": list(rec.bbox)},
          "libraries": libs, "auto_backend": chosen,
          "stream_auto_top1_equal_predict": True,
          "stream_auto_max_logit_err": err, "atol": LANE_LOGIT_ATOL})


def phase_pose_lane():
    """``pose_bilstm`` at full width on the card: against the CPU, the
    pose-only stream against ``predict``, device-only clips/s."""
    from asltpu_torch import api
    from asltpu_torch.data.landmarks import LandmarkStore
    from asltpu_torch.data.synthetic import synthetic_landmarks
    from asltpu_torch.ops import preprocess_kernels as k

    model = api.load_model("pose_bilstm", seed=SEED)
    cfg = model.cfg
    assert (cfg.num_landmarks, cfg.landmark_dim, cfg.num_frames, cfg.hidden_size,
            cfg.num_layers, cfg.num_classes) == (543, 3, 32, 256, 2, 100)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in model.module.parameters())
    lm = synthetic_landmarks(POSE_BATCH, cfg.num_frames, seed=SEED + 5)
    lm[0, 3] = 0.0                 # nothing detected in one frame
    lm[1, 4, 12] = lm[1, 4, 11]    # no usable pose in another
    torch.cuda.synchronize()
    k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
    # PyTorch's default lets cuDNN use TF32 (phase device turned it off for
    # the other phases): the model keeps its LSTM fp32 itself.
    torch.backends.cudnn.allow_tf32 = True
    try:
        ids, logits = api.predict(model, lm)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    launches = {"preprocess_rgb": k.preprocess_rgb.launches,
                "preprocess_yuv420": k.preprocess_yuv420.launches}
    assert launches == {"preprocess_rgb": 0, "preprocess_yuv420": 0}, launches
    assert logits.shape == (POSE_BATCH, 100) and np.isfinite(logits).all()
    # The control: TF32 on inside the LSTM must leave the bound, or the
    # bound could not tell an LSTM that slipped into TF32.
    model.module.lstm_tf32 = True
    try:
        _, tf32_logits = api.predict(model, lm)
    finally:
        model.module.lstm_tf32 = False
    cpu_ids, cpu_logits = api.predict(api.load_model("pose_bilstm", seed=SEED,
                                                     device="cpu"), lm)
    err = float(np.abs(logits - cpu_logits).max())
    tf32_err = float(np.abs(tf32_logits - cpu_logits).max())
    spread = float(np.abs(cpu_logits - cpu_logits.mean(0)).max())
    if err > POSE_CPU_ATOL or not (ids == cpu_ids).all():
        raise AssertionError(f"pose_bilstm on the card vs the CPU: max logit err {err}")
    if tf32_err <= POSE_CPU_ATOL:
        raise AssertionError(f"the pose bound {POSE_CPU_ATOL} does not see a TF32 "
                             f"LSTM: max logit err {tf32_err} (fp32: {err})")
    with tempfile.TemporaryDirectory() as d:
        store = LandmarkStore(d)
        raw = synthetic_landmarks(POSE_BATCH + 8, 48, seed=SEED + 6)
        paths = []
        for i, seq in enumerate(raw):
            store.put(f"clip{i:03d}", seq)
            paths.append(f"/videos/clip{i:03d}.mp4")
        out = list(api.stream_predict(model, paths, batch_size=POSE_BATCH,
                                      landmarks_for=store.for_path(cfg.num_frames)))
        staged = np.stack([store.get(f"clip{i:03d}", cfg.num_frames)
                           for i in range(len(paths))])
    want = np.concatenate([api.predict(model, staged[i:i + POSE_BATCH])[1]
                           for i in range(0, len(paths), POSE_BATCH)])
    got = np.stack([lg for _, _, lg in out])
    stream_err = float(np.abs(got - want).max())
    if [p for p, _, _ in out] != paths or stream_err > POSE_CPU_ATOL:
        raise AssertionError(f"pose stream_predict vs predict: max logit err {stream_err}")
    x = torch.from_numpy(lm).to(model.device)
    fn = model.predict_fn()
    ms = time_ms(lambda: fn(x), PREDICT_REPS)
    emit({"phase": "pose_lane", "family": "pose_bilstm", "input": list(lm.shape),
          "compute_dtype": cfg.compute_dtype, "launches": launches,
          "max_logit_err_vs_cpu": err, "atol": POSE_CPU_ATOL,
          "tf32_lstm_control_max_logit_err_vs_cpu": tf32_err,
          "logit_spread": spread, "distinct_top1": len(set(cpu_ids.tolist())),
          "stream_clips": len(out), "stream_max_logit_err_vs_predict": stream_err,
          "device_ms_per_batch": ms, "device_clips_per_s": POSE_BATCH / ms * 1e3})
    del model, x
    torch.cuda.empty_cache()


# The train phase: I3D at full width (TrainConfig's batch, bf16 compute with
# fp32 masters, remat on), random weights from SEED.
TRAIN_BATCH = 8
# Kernel vs plain preprocess on the first step: the bf16 rgb kernel is
# bit-exact to the plain version at this shape (phase kernels), so the two
# steps differ only by cuDNN's backward, whose weight gradients are not
# bit-deterministic: loss within 1e-3 and grad_norm within 1e-2 relative.
TRAIN_PLAIN_LOSS_RTOL, TRAIN_PLAIN_GRAD_RTOL = 1e-3, 1e-2
# Remat on vs off: the same loss (1e-3 relative) and the same running
# statistics within 1e-3 of each tensor's largest entry; updating them a
# second time moves them by a tenth of (batch − running), far outside.
TRAIN_REMAT_RTOL = 1e-3
# Card vs CPU: the fp32 step at the CPU test's size (TF32 off, fp32
# preprocess out, dropout 0), the first of a warmup (lr 0). The loss, the
# parameters and the running statistics within 1e-4 relative (global norm).
# The gradient (Adam's first moment over 0.1, no clip) is held to the CPU's
# fp64 one: the card's fp32 gradient no farther from it than twice the
# CPU's fp32 gradient, and 1e-3. At these sizes the deepest BatchNorms see
# 16-32 values a channel and amplify rounding, by an amount that depends
# on the weights (the phase prints the CPU's distance; 0.63% at
# tests/test_torch_train_i3d.py's weights, 0.49% for resnet_transformer at
# tests/test_torch_train_video.py's), so no fixed bound fits. After an
# update with lr > 0 the parameters are no test: Adam's first update is
# lr·sign(g), and entries whose gradient is rounding noise flip sign.
# The sizes are the CPU tests' (tests/test_torch_train_i3d.py,
# tests/test_torch_train_video.py, tests/test_torch_train_fusion.py).
_CPU_PP = {"num_frames": 4, "staging_size": (40, 48), "resize_short": 36, "crop": 32,
           "out_dtype": "float32"}
TRAIN_CPU_SIZES = {
    "i3d": {"num_classes": 7, "preprocess": dict(_CPU_PP, num_frames=16)},
    "mobilenet_gru": {"num_classes": 7, "width_mult": 0.35, "gru_hidden": 32,
                      "preprocess": _CPU_PP},
    "resnet_transformer": {"num_classes": 7, "d_model": 32, "num_heads": 4,
                           "num_tx_layers": 2, "preprocess": {
                               "num_frames": 3, "staging_size": (64, 80),
                               "resize_short": 56, "crop": 48, "out_dtype": "float32"}},
    "two_stream": {"num_classes": 7, "width_mult": 0.35, "d_model": 64, "num_heads": 4,
                   "num_fusion_layers": 2, "preprocess": _CPU_PP},
}
TRAIN_CPU_RTOL, TRAIN_CPU_GRAD_SLACK = 1e-4, 1e-3
# Resume: the losses of the resumed steps against the uninterrupted run's,
# within three times the largest gap between the runs that were not cut
# (two whole runs and the cut run before its fault): cuDNN's backward and
# max-pool's are not bit-deterministic, and Adam's sign-like updates carry
# the gap from step to step. Where the runs agree bit for bit (the spread
# is 0, as mobilenet_gru's runs do on the card), the bound is 1e-5 of the
# largest loss, so that a backward that is not bit-deterministic on another
# card does not fail a resume that works. The step, the batches taken, the
# generator's state and the lr must be exact.
TRAIN_RESUME_SPREADS, TRAIN_RESUME_FLOOR = 3, 1e-5
# The families trained after I3D, each at full width (FAMILIES' config
# values, which are the config defaults) at TrainConfig's batch of 8 from
# 256² RGB staged; mobilenet_gru (the north star) also learns and resumes,
# the others run a short train() with eval.
TRAIN_FAMILIES = ("mobilenet_gru", "resnet_transformer", "two_stream")
TRAIN_SHORT_STEPS = 4


class SeededBatches:
    """A stream of staged uint8 batches and labels made on the card, batch
    i from a generator seeded ``seed · 1000 + i``, with the position as its
    state (``get_state``/``set_state``, as the train loader's), so
    ``ResumableIterator`` and a checkpoint can carry it. With
    ``landmarks`` (a [B, T, 543, 3] tensor) each batch is ``((frames,
    landmarks), labels)``, as ``two_stream`` trains."""

    def __init__(self, shape, num_classes, device, seed=SEED, landmarks=None):
        self.shape, self.num_classes, self.device, self.seed = shape, num_classes, device, seed
        self.landmarks = landmarks
        self.i = 0
        self.taken = []

    def __iter__(self):
        return self

    def __next__(self):
        gen = torch.Generator(self.device).manual_seed(self.seed * 1000 + self.i)
        x = torch.randint(0, 256, self.shape, dtype=torch.uint8, device=self.device,
                          generator=gen)
        y = torch.randint(0, self.num_classes, (self.shape[0],), device=self.device,
                          generator=gen)
        self.taken.append(self.i)
        self.i += 1
        return (x if self.landmarks is None else (x, self.landmarks)), y

    def get_state(self) -> bytes:
        return str(self.i).encode()

    def set_state(self, state: bytes) -> None:
        self.i = int(state)


def _global_rel(a, b) -> float:
    """‖a − b‖ over ‖b‖, over the floating tensors of ``b`` (a dict of
    tensors) and the same keys of ``a``."""
    keys = [k for k, t in b.items() if t.is_floating_point()]
    num = sum(float(((a[k].double().cpu() - b[k].double().cpu()) ** 2).sum()) for k in keys)
    return (num / sum(float((b[k].double().cpu() ** 2).sum()) for k in keys)) ** 0.5


def _only(sd, word, keep):
    """The entries of ``sd`` whose key holds ``word`` (``keep``) or not."""
    return {k: t for k, t in sd.items() if (word in k) == keep}


def _train_landmarks(name, batch, t, seed, device):
    """Seeded landmarks [batch, t, 543, 3] on ``device`` for ``two_stream``,
    else None."""
    from asltpu_torch.data.synthetic import synthetic_landmarks

    if name != "two_stream":
        return None
    return torch.from_numpy(synthetic_landmarks(batch, t, seed=seed)).to(device)


def _with_landmarks(x, lm):
    return x if lm is None else (x, lm)


def _train_card_vs_cpu(name="i3d"):
    """The fp32 train step at the CPU test's size on the card and on the
    CPU (then the CPU's fp64 gradient), from the same seeded weights and
    batch (module constants above)."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.ops.preprocess import preprocess_clip
    from asltpu_torch.train import loop

    size = TRAIN_CPU_SIZES[name]
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, warmup_steps=1, num_steps=10,
                       grad_clip_norm=1e30)
    rng = np.random.default_rng(SEED + 12)
    pp = size["preprocess"]
    frames = rng.integers(0, 256, (TRAIN_BATCH, pp["num_frames"], *pp["staging_size"], 3),
                          np.uint8)
    labels = rng.integers(0, size["num_classes"], TRAIN_BATCH).astype(np.int32)
    lm = _train_landmarks(name, TRAIN_BATCH, pp["num_frames"], SEED + 12, "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        # Dropout 0: the card's generator draws other masks than the CPU's.
        model = api.build_trainable(name, seed=SEED, device=dev, compute_dtype="float32",
                                    dropout=0.0, **size)
        state = loop.create_train_state(model.module, tcfg, SEED)
        state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(
            state, _with_landmarks(frames, lm), labels)
        grads = {n: (state.optimizer.state[p]["exp_avg"] / 0.1).cpu()
                 for n, p in model.module.named_parameters() if p.requires_grad}
        out[dev] = (float(metrics["loss"]), {k: t.detach().cpu() for k, t in
                                             model.module.state_dict().items()}, grads)
    m64 = api.build_trainable(name, seed=SEED, device="cpu", compute_dtype="float64",
                              dropout=0.0, **size)
    m64 = m64.module.double()
    pp_cfg = api.get_config(name, **size).preprocess
    clip = preprocess_clip(torch.from_numpy(frames), pp_cfg).double()
    extras = () if lm is None else (lm.double(),)
    loss64 = loop.softmax_ce(m64(clip, *extras, train=True), torch.from_numpy(labels),
                             tcfg.label_smoothing)
    trained = [(n, p) for n, p in m64.named_parameters() if p.requires_grad]
    g64 = dict(zip([n for n, _ in trained],
                   torch.autograd.grad(loss64, [p for _, p in trained])))
    (card_loss, card_sd, card_g), (cpu_loss, cpu_sd, cpu_g) = out["cuda"], out["cpu"]
    result = {"size": size, "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
              "params_rel_err": _global_rel(card_sd, _only(cpu_sd, "running", False)),
              "running_stats_rel_err": _global_rel(card_sd, _only(cpu_sd, "running", True)),
              "grad_rel_err_vs_fp64": _global_rel(card_g, g64),
              "cpu_grad_rel_err_vs_fp64": _global_rel(cpu_g, g64),
              "grad_rel_err_vs_cpu": _global_rel(card_g, cpu_g),
              "rtol": TRAIN_CPU_RTOL}
    result["grad_bound"] = 2 * result["cpu_grad_rel_err_vs_fp64"] + TRAIN_CPU_GRAD_SLACK
    if (max(result["loss_rel_err"], result["params_rel_err"], result["running_stats_rel_err"])
            > TRAIN_CPU_RTOL or result["grad_rel_err_vs_fp64"] > result["grad_bound"]):
        raise AssertionError(f"{name} train step on the card vs the CPU: {result}")
    return result


def _first_steps(batch, labels, name="i3d", variants=None):
    """One train step (the first of a warmup: lr 0) from the same seeded
    weights on the same batch, per variant of the config: by default (I3D)
    remat on with the rgb kernel (the main configuration), remat on with
    the plain preprocess, remat off with the kernel. Returns {variant:
    (loss, grad_norm, state_dict, peak GB)}."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train import loop

    if variants is None:
        variants = (("kernel", {}), ("plain", {"preprocess": {"use_pallas": False}}),
                    ("no_remat", {"remat": False}))
    tcfg = TrainConfig()
    out = {}
    for variant, over in variants:
        model = api.build_trainable(name, seed=SEED, **over)
        state = loop.create_train_state(model.module, tcfg, SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = loop.make_step_fn(tcfg, model.cfg.preprocess)(state, batch, labels)
        torch.cuda.synchronize()
        out[variant] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        {k: t.detach().clone() for k, t in model.module.state_dict().items()},
                        torch.cuda.max_memory_allocated() / 1e9)
        del model, state
        torch.cuda.empty_cache()
    return out


def _train_run(ckdir, num_steps, fault=-1, name="i3d"):
    """``train()`` (warmup 2, a checkpoint every 2 steps) over a
    :class:`SeededBatches` stream, resumed with its data state where
    ``ckdir`` holds one: returns (the step, generator state and lr at the
    end, or None after the injected fault; losses by step; the batches
    taken)."""
    from asltpu_torch import api
    from asltpu_torch import ckpt
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.data.loader import ResumableIterator
    from asltpu_torch.train import loop

    model = api.build_trainable(name, seed=SEED)
    cfg = model.cfg
    shape = (TRAIN_BATCH, cfg.preprocess.num_frames, *cfg.preprocess.staged_frame_shape)
    stream = SeededBatches(shape, cfg.num_classes, model.device)
    saved = ckpt.load_data_state(ckdir)
    if saved is not None:
        stream.set_state(saved)
    rit = ResumableIterator(stream)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, num_steps=num_steps, warmup_steps=2,
                       log_every=1, ckpt_every=2, ckpt_dir=ckdir, fault_inject_step=fault)
    losses = {}

    def writer(step, metrics):
        if "loss" in metrics:
            losses[step] = metrics["loss"]

    try:
        state = loop.train(model.module, tcfg, rit, pp_cfg=cfg.preprocess, metric_writer=writer,
                           resumable_iter=rit)
    except loop.FaultInjected:
        return None, losses, stream.taken
    return ((state.step, state.generator.get_state(), state.schedule.get_last_lr()),
            losses, stream.taken)


def _train_and_eval(name, cfg, batches, eval_set, num_steps):
    """The main path of a family's training: ``train()`` over ``batches``
    (warmup 2) with its eval on ``eval_set`` at the end and keep-best, the
    kernels' counts set to 0 just before it; the rgb kernel's launches in
    the train steps (read when the eval begins) and in the eval, and the
    max-pool kernels' [forward, backward] in each. Returns (state, losses,
    launches, pool launches, best metric)."""
    from asltpu_torch import api, ckpt
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.train import loop

    counts = {}

    def eval_batches():
        counts["before_eval"] = k.preprocess_rgb.launches
        counts["pools_before_eval"] = pool_launches()
        return eval_set

    losses = []
    with tempfile.TemporaryDirectory(prefix="asltpu_torch_train_") as ckdir:
        learner = api.build_trainable(name, seed=SEED)
        tcfg = TrainConfig(batch_size=TRAIN_BATCH, num_steps=num_steps, warmup_steps=2,
                           log_every=1, eval_every=num_steps, ckpt_every=10_000,
                           ckpt_dir=ckdir)
        torch.cuda.synchronize()
        k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
        reset_pool_launches()
        state = loop.train(learner.module, tcfg, batches, pp_cfg=cfg.preprocess,
                           metric_writer=lambda s, m: losses.append(m.get("loss")),
                           eval_batches=eval_batches)
        torch.cuda.synchronize()
        launches = {f"{name}/train": counts["before_eval"],
                    f"{name}/eval": k.preprocess_rgb.launches - counts["before_eval"]}
        pools = {f"{name}/train": counts["pools_before_eval"],
                 f"{name}/eval": [a - b for a, b in zip(pool_launches(),
                                                        counts["pools_before_eval"])]}
        best = ckpt.load_best_metric(ckdir)
    want = {f"{name}/train": num_steps, f"{name}/eval": len(eval_set)}
    assert state.step == num_steps and launches == want, launches
    i3d = name == "i3d"  # remat on: the recompute runs its pools again
    want_pools = {f"{name}/train": [num_steps * (I3D_POOLS + I3D_REMAT_POOLS) * i3d,
                                    num_steps * I3D_POOLS * i3d],
                  f"{name}/eval": [len(eval_set) * I3D_POOLS * i3d, 0]}
    if pools != want_pools:
        raise AssertionError(f"{name} train: max-pool launches {pools}, want {want_pools}")
    assert k.preprocess_yuv420.launches == 0
    train_losses = [x for x in losses if x is not None]
    if not np.isfinite(train_losses).all():
        raise AssertionError(f"{name} train: losses not finite: {train_losses}")
    return state, train_losses, launches, pools, best


def _resume_check(name):
    """Two uninterrupted runs and the cut run before its fault give the
    spread; the run cut at step 5 (after the step-4 checkpoint) resumes in
    this process and must continue the uninterrupted run."""
    runs = {}
    with tempfile.TemporaryDirectory(prefix="asltpu_torch_resume_") as root:
        for run, fault in (("a", -1), ("b", -1), ("cut", 5), ("resumed", -1)):
            ckdir = os.path.join(root, "cut" if run == "resumed" else run)
            runs[run] = _train_run(ckdir, 6, fault, name)
            torch.cuda.empty_cache()
    whole = [runs[n][1] for n in ("a", "b", "cut")]
    spread = max(abs(x[s] - y[s]) for i, x in enumerate(whole) for y in whole[i + 1:]
                 for s in x if s in y)
    a, resumed = runs["a"][1], runs["resumed"][1]
    resume_err = max(abs(resumed[s] - a[s]) for s in resumed)
    bound = max(TRAIN_RESUME_SPREADS * spread,
                TRAIN_RESUME_FLOOR * max(abs(x) for run in whole for x in run.values()))
    # The loop pulls one batch more than it runs when it stops.
    consumed = runs["resumed"][2][:len(resumed)]
    end, want_end = runs["resumed"][0], runs["a"][0]
    resume = {"steps_resumed": sorted(resumed), "batches_consumed": consumed,
              "spread_of_runs_not_cut": spread, "max_loss_err_vs_uninterrupted": resume_err,
              "bound": bound, "losses_uninterrupted": [a[s] for s in sorted(a)],
              "losses_cut_then_resumed": [runs["cut"][1][s] for s in sorted(runs["cut"][1])]
              + [resumed[s] for s in sorted(resumed)],
              "generator_state_equal": bool(torch.equal(end[1], want_end[1])),
              "lr": end[2], "lr_uninterrupted": want_end[2]}
    if (end[0] != 6 or sorted(resumed) != [5, 6] or consumed != [4, 5]
            or sorted(runs["cut"][1]) != [1, 2, 3, 4, 5] or not resume["generator_state_equal"]
            or end[2] != want_end[2] or resume_err > bound):
        raise AssertionError(f"{name} train: resume does not continue the run: {resume}")
    return resume


I3D_TRAIN_STEPS = 10


def phase_train():
    """I3D fine-tuning at full width on the card, then the other families'
    training (module docstring, phase 15). Returns the rgb kernel's
    launches by path and I3D's max-pool launches by path, [forward,
    backward]."""
    from asltpu_torch import api

    model = api.build_trainable("i3d", seed=SEED)
    cfg = model.cfg
    assert (cfg.num_classes, cfg.num_frames, cfg.preprocess.crop, cfg.compute_dtype,
            cfg.remat) == (2000, 64, 224, "bfloat16", True), cfg
    assert cfg.preprocess.staged_frame_shape == (256, 256, 3)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in model.module.parameters())
    shape = (TRAIN_BATCH, cfg.preprocess.num_frames, *cfg.preprocess.staged_frame_shape)
    batch, labels = next(SeededBatches(shape, cfg.num_classes, model.device, seed=SEED + 13))
    del model

    first = _first_steps(batch, labels)
    (k_loss, k_norm, k_sd, k_peak), (p_loss, p_norm, _, _), (r_loss, _, r_sd, r_peak) = (
        first["kernel"], first["plain"], first["no_remat"])
    stats = [key for key in k_sd if "running" in key]
    remat_stats_err = max(_rel_err(k_sd[key], r_sd[key]) for key in stats)
    checks = {
        "loss": k_loss, "grad_norm": k_norm,
        "loss_rel_err_vs_plain": abs(k_loss - p_loss) / abs(p_loss),
        "grad_norm_rel_err_vs_plain": abs(k_norm - p_norm) / abs(p_norm),
        "plain_rtol": [TRAIN_PLAIN_LOSS_RTOL, TRAIN_PLAIN_GRAD_RTOL],
        "loss_rel_err_remat_vs_not": abs(k_loss - r_loss) / abs(r_loss),
        "running_stats_rel_err_remat_vs_not": remat_stats_err, "remat_rtol": TRAIN_REMAT_RTOL,
        "peak_gb_remat": k_peak, "peak_gb_no_remat": r_peak,
    }
    del first, k_sd, r_sd
    if (checks["loss_rel_err_vs_plain"] > TRAIN_PLAIN_LOSS_RTOL
            or checks["grad_norm_rel_err_vs_plain"] > TRAIN_PLAIN_GRAD_RTOL):
        raise AssertionError(f"train step: kernel vs plain preprocess disagree: {checks}")
    if (checks["loss_rel_err_remat_vs_not"] > TRAIN_REMAT_RTOL
            or remat_stats_err > TRAIN_REMAT_RTOL):
        raise AssertionError(f"train step: remat on vs off disagree: {checks}")
    checks["card_vs_cpu"] = _train_card_vs_cpu()

    # The main path: train() for I3D_TRAIN_STEPS steps on one fixed batch
    # (warmup 2), then its eval; the kernels' launches counted per path.
    eval_stream = SeededBatches(shape, cfg.num_classes, torch.device("cuda"), seed=SEED + 14)
    eval_set = [next(eval_stream) for _ in range(2)]
    state, train_losses, launches, pools, best = _train_and_eval(
        "i3d", cfg, [(batch, labels)] * I3D_TRAIN_STEPS, eval_set, I3D_TRAIN_STEPS)
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"train: the loss did not fall on a fixed batch: {train_losses}")
    del state
    resume = _resume_check("i3d")

    del batch
    torch.cuda.empty_cache()
    emit({"phase": "train", "family": "i3d", "input": list(shape), "batch": TRAIN_BATCH,
          "compute_dtype": cfg.compute_dtype, "param_dtype": "float32", "remat": True,
          "launches": launches, "pool_launches": pools, "first_step": checks,
          "learning_losses": train_losses, "best": best, "resume": resume})
    for name in TRAIN_FAMILIES:
        launches.update(_train_family(name))
    return launches, pools


def _train_timing(name, cfg, batch_in, labels):
    """The family's train step at full width, timed by CUDA events (input
    and labels varied from step to step, as the bench's ``i3d:train``
    cell), its peak memory and its GFLOP per clip of forward + backward."""
    from asltpu_torch import api
    from asltpu_torch.benchmark import Clock, train_gflops
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train import loop

    model = api.build_trainable(name, seed=SEED)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, num_steps=1000, warmup_steps=100)
    state = loop.create_train_state(model.module, tcfg, SEED)
    step_fn = loop.make_step_fn(tcfg, cfg.preprocess)
    frames, *extras = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    inputs = [(_with_landmarks(frames + k, extras[0] if extras else None),
               (labels + k) % cfg.num_classes) for k in range(2)]
    turn = [0]

    def step():
        b, y = inputs[turn[0] % 2]
        turn[0] += 1
        return step_fn(state, b, y)

    ms = Clock(torch.device("cuda"), reps=5, samples=SAMPLES, warmup=3).ms(step)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    gflops = train_gflops(state, step_fn, *inputs[0]) / TRAIN_BATCH
    del model, state, inputs
    torch.cuda.empty_cache()
    clips = TRAIN_BATCH * 1e3 / ms
    return {"ms_per_step": ms, "clips_per_s": clips, "peak_mem_gb": peak,
            "gflops_per_clip": gflops,
            "mfu": gflops * 1e9 * clips / PEAK_BF16_FLOP_PER_S}


def _train_family(name):
    """``name``'s training at full width (module docstring, phase 15):
    the first step against its plain-preprocess twin, the fp32 step on the
    card against the CPU, the main path (``train()`` with eval; for
    ``mobilenet_gru`` 10 steps on a fixed batch that the loss must fall
    on, then a fault and resume), the step's timings. Emits its line and
    prints the timings, each on a line of its own; returns the rgb
    kernel's launches by path."""
    from asltpu_torch import api

    model = api.build_trainable(name, seed=SEED)
    cfg = model.cfg
    want = {key: getattr(cfg, key) for key in FAMILIES[name]["config"]}
    assert want == FAMILIES[name]["config"], (name, want)
    assert cfg.compute_dtype == "bfloat16" and cfg.preprocess.crop == 224, cfg
    assert cfg.preprocess.staged_frame_shape == (256, 256, 3)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in model.module.parameters())
    t = cfg.preprocess.num_frames
    shape = (TRAIN_BATCH, t, *cfg.preprocess.staged_frame_shape)
    lm = _train_landmarks(name, TRAIN_BATCH, t, SEED + 15, model.device)
    del model
    batch, labels = next(SeededBatches(shape, cfg.num_classes, torch.device("cuda"),
                                       seed=SEED + 13, landmarks=lm))

    first = _first_steps(batch, labels, name, (
        ("kernel", {}), ("plain", {"preprocess": {"use_pallas": False}})))
    (k_loss, k_norm, _, k_peak), (p_loss, p_norm, _, _) = first["kernel"], first["plain"]
    checks = {"loss": k_loss, "grad_norm": k_norm, "loss_plain": p_loss,
              "grad_norm_rel_err_vs_plain": abs(k_norm - p_norm) / abs(p_norm),
              "plain_rtol": [0.0, TRAIN_PLAIN_GRAD_RTOL], "peak_gb": k_peak}
    del first
    if k_loss != p_loss or checks["grad_norm_rel_err_vs_plain"] > TRAIN_PLAIN_GRAD_RTOL:
        raise AssertionError(f"{name} train step: kernel vs plain preprocess disagree: "
                             f"{checks}")
    checks["card_vs_cpu"] = _train_card_vs_cpu(name)

    eval_stream = SeededBatches(shape, cfg.num_classes, torch.device("cuda"),
                                seed=SEED + 14, landmarks=lm)
    eval_set = [next(eval_stream) for _ in range(2)]
    learns = name == "mobilenet_gru"
    steps = 10 if learns else TRAIN_SHORT_STEPS
    state, losses, launches, pools, best = _train_and_eval(
        name, cfg, [(batch, labels)] * steps, eval_set, steps)
    del state
    line = {"phase": "train", "family": name, "input": list(shape),
            "landmarks": None if lm is None else list(lm.shape), "batch": TRAIN_BATCH,
            "compute_dtype": cfg.compute_dtype, "param_dtype": "float32",
            "launches": launches, "pool_launches": pools, "first_step": checks, "losses": losses, "best": best}
    if learns:
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name} train: the loss did not fall on a fixed batch: "
                                 f"{losses}")
        line["resume"] = _resume_check(name)
    timing = _train_timing(name, cfg, batch, labels)
    line["timing"] = timing
    del batch, eval_set
    torch.cuda.empty_cache()
    emit(line)
    print(f"{name} train step ms (cuda events, median, batch {TRAIN_BATCH}): "
          f"{timing['ms_per_step']}", flush=True)
    print(f"{name} train clips/s: {timing['clips_per_s']}", flush=True)
    print(f"{name} train peak GB: {timing['peak_mem_gb']}", flush=True)
    print(f"{name} train GFLOP per clip (forward + backward): {timing['gflops_per_clip']}",
          flush=True)
    print(f"{name} train MFU: {timing['mfu']}", flush=True)
    return launches


def phase_timesformer():
    """TimeSformer-HR's predict and train step at full width (module
    docstring, phase 21). Returns the rgb kernel's launches by path."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.ops import short_attention_kernels as sa
    from asltpu_torch.train.loop import create_train_state, make_train_step

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k.preprocess_rgb.launches = 0
        att.fused_attention.calls = att.plain_attention.calls = 0
        sa.short_attention.launches = sa.short_attention_backward.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {"preprocess_rgb": k.preprocess_rgb.launches,
               "fused_attention": att.fused_attention.calls,
               "plain_attention": att.plain_attention.calls,
               "short_attention": sa.short_attention.launches,
               "short_attention_backward": sa.short_attention_backward.launches,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        return out, got

    def check(path, got, runs, backward):
        want = {"preprocess_rgb": runs, "fused_attention": runs * TSF_BLOCKS,
                "plain_attention": 0, "short_attention": runs * TSF_BLOCKS,
                "short_attention_backward": runs * TSF_BLOCKS if backward else 0}
        if {key: got[key] for key in want} != want:
            raise AssertionError(f"timesformer {path}: launches and calls {got}, want {want}")

    model = api.load_model("timesformer", seed=SEED)
    cfg = model.cfg
    assert (cfg.num_classes, cfg.num_frames, cfg.patch_size, cfg.embed_dim, cfg.depth,
            cfg.num_heads, cfg.mlp_ratio, cfg.compute_dtype) == (
            2000, 16, 16, 768, 12, 12, 4, "bfloat16"), cfg
    assert cfg.preprocess.crop == 448 and cfg.preprocess.staged_frame_shape == (512, 512, 3)
    norms = assert_norms_fp32(model.module)
    frames = np.random.default_rng(SEED + 16).integers(
        0, 256, (TSF_BATCH, cfg.num_frames, *cfg.preprocess.staged_frame_shape), np.uint8)
    (ids, logits), predicted = counted(lambda: api.predict(model, frames))
    check("predict", predicted, 1, backward=False)
    assert logits.shape == (TSF_BATCH, cfg.num_classes) and np.isfinite(logits).all()
    del model
    plain = api.load_model("timesformer", seed=SEED, preprocess={"use_pallas": False})
    _, plain_logits = api.predict(plain, frames)
    del plain
    err = float(np.abs(logits - plain_logits).max())
    if err > LANE_LOGIT_ATOL:
        raise AssertionError(f"timesformer predict: kernel and plain preprocess disagree "
                             f"(max logit err {err})")
    torch.cuda.empty_cache()

    model = api.build_trainable("timesformer", seed=SEED)
    assert all(p.dtype == torch.float32 and p.is_cuda for p in model.module.parameters())
    tcfg = TrainConfig(batch_size=TSF_BATCH, num_steps=1000, warmup_steps=100)
    state = create_train_state(model.module, tcfg, SEED)
    step = make_train_step(tcfg, model.cfg.preprocess)
    shape = (TSF_BATCH, cfg.num_frames, *cfg.preprocess.staged_frame_shape)
    stream = SeededBatches(shape, cfg.num_classes, torch.device("cuda"), seed=SEED + 17)
    batches = [next(stream) for _ in range(2)]

    def two_steps():
        nonlocal state
        out = []
        for b, y in batches:
            state, metrics = step(state, b, y)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        return out

    steps, trained = counted(two_steps)
    check("train", trained, 2, backward=True)
    if not all(np.isfinite(v) and v > 0 for pair in steps for v in pair):
        raise AssertionError(f"timesformer train: loss and grad_norm {steps}")
    del model, state, batches
    torch.cuda.empty_cache()
    emit({"phase": "timesformer", "input": list(frames.shape), "batch": TSF_BATCH,
          "compute_dtype": cfg.compute_dtype, "param_dtype": "float32",
          "norm_layers_fp32": norms, "predict": predicted,
          "max_logit_err_vs_plain": err, "atol": LANE_LOGIT_ATOL,
          "distinct_top1": len(set(ids.tolist())), "train": trained,
          "loss_grad_norm": steps})
    return ({"timesformer/predict": predicted["preprocess_rgb"],
             "timesformer/train": trained["preprocess_rgb"]},
            {path: [got["short_attention"], got["short_attention_backward"]]
             for path, got in (("timesformer/predict", predicted),
                               ("timesformer/train", trained))})


def phase_short_attention():
    """The short-sequence attention kernels at TimeSformer-HR's temporal
    layer (module docstring, phase 22): checked against the plain version
    and timed. Returns the summary."""
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import short_attention_kernels as sa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(SEED + 50)
    n, length, width = SHORT_SHAPE
    h = SHORT_HEADS
    qkv = torch.randn(SHORT_SHAPE, generator=gen, device=dev).bfloat16()
    grad = torch.randn((n, length, width // 3), generator=gen, device=dev).bfloat16()
    out = sa.short_attention(qkv, h)
    grad_qkv = sa.short_attention_backward(grad, qkv, h)
    again = sa.short_attention_backward(grad, qkv, h)
    torch.cuda.synchronize()
    q32 = qkv.float()
    errs = {}
    for key, got, want in (
            ("out", out, sa.short_attention_plain(q32, h)),
            ("grad_qkv", grad_qkv, sa.short_attention_backward_plain(grad.float(), q32, h))):
        errs[key] = float((got.float() - want).abs().max()) / float(want.abs().max())
    row = {"shape": list(SHORT_SHAPE), "heads": h, "dtype": "bfloat16",
           "max_err_rel_to_max": errs, "tolerance": 2 ** -6,
           "backward_bit_identical": bool(torch.equal(grad_qkv.view(torch.int16),
                                                      again.view(torch.int16)))}
    del q32, again
    if not (max(errs.values()) <= 2 ** -6 and row["backward_bit_identical"]):
        raise AssertionError(f"short_attention disagrees with its plain version: {row}")

    def library_forward(x):
        q, k_, v = (x.view(n, length, 3, h, 64)[:, :, i].transpose(1, 2) for i in range(3))
        return att.fused_attention(q, k_, v).transpose(1, 2).reshape(n, length, width // 3)

    leaf = qkv.detach().requires_grad_()
    library_out = library_forward(leaf)

    fns = {
        "fwd": lambda: sa.short_attention(qkv, h),
        "bwd": lambda: sa.short_attention_backward(grad, qkv, h),
        "library_fwd": lambda: library_forward(qkv),
        "library_bwd": lambda: torch.autograd.grad(library_out, leaf, grad, retain_graph=True),
        "plain_fwd": lambda: sa.short_attention_plain(qkv, h),
        "plain_bwd": lambda: sa.short_attention_backward_plain(grad, qkv, h),
    }
    ms = {}
    for name in ("library_fwd", "fwd", "fwd", "library_fwd", "library_bwd", "bwd", "bwd",
                 "library_bwd", "plain_fwd", "plain_bwd"):
        ms.setdefault(name, []).append(time_ms(fns[name], SHORT_REPS))
    del library_out, leaf
    item = qkv.element_size()
    fwd_bytes = (qkv.numel() + out.numel()) * item
    bwd_bytes = (qkv.numel() + grad.numel() + grad_qkv.numel()) * item
    row.update({
        "ms_fwd": min(ms["fwd"]), "ms_bwd": min(ms["bwd"]),
        "library_ms_fwd": min(ms["library_fwd"]), "library_ms_bwd": min(ms["library_bwd"]),
        "plain_ms_fwd": ms["plain_fwd"][0], "plain_ms_bwd": ms["plain_bwd"][0],
        "ms_runs": ms, "bytes_fwd": fwd_bytes, "bytes_bwd": bwd_bytes,
        "bound_ms_fwd": fwd_bytes / PEAK_BYTES_PER_S * 1e3,
        "bound_ms_bwd": bwd_bytes / PEAK_BYTES_PER_S * 1e3,
        "library": "fused_attention (cuDNN, flash, memory-efficient) on q, k, v views, "
                   "autograd's backward to qkv"})
    row["share_of_bound"] = ((row["bound_ms_fwd"] + row["bound_ms_bwd"])
                             / (row["ms_fwd"] + row["ms_bwd"]))
    del qkv, grad, out, grad_qkv
    torch.cuda.empty_cache()
    emit({"phase": "short_attention", **row,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S, "source": "H100 SXM data sheet"}})
    return row


def phase_window_attention():
    """The window attention kernels at two of Video Swin-B's shifted layers
    (module docstring, phase 23): checked against the plain version and
    timed beside the path they replaced. Returns the summary, a row a
    layer."""
    from asltpu_torch.models import video_swin as vs
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import window_attention_kernels as wk

    dev = torch.device("cuda", 0)
    full = (8, 7, 7)
    rows = {}
    for name, size, h in WINDOW_LAYERS:
        window, shift = vs.clip_window(size, full, tuple(k // 2 for k in full))
        regions = vs.shift_regions(size, window, shift, dev)
        n, length = WINDOW_BATCH * regions.shape[0], math.prod(window)
        gen = torch.Generator(dev).manual_seed(SEED + 60)
        qkv = torch.randn((n, length, 3 * 32 * h), generator=gen, device=dev).bfloat16()
        table = torch.randn((wk.table_rows(full), h), generator=gen, device=dev)
        grad = torch.randn((n, length, 32 * h), generator=gen, device=dev).bfloat16()
        out, rest, lse = torch.ops.asltpu_torch.window_attention(qkv, h, table, list(full),
                                                                 regions)
        grad_qkv, grad_table = wk.window_attention_kernel_backward(grad, qkv, out, rest, lse, h,
                                                                   table, full, regions)
        torch.cuda.synchronize()
        q32 = qkv.float()
        want, _, want_lse = wk.window_attention_plain(q32, h, table, full, regions)
        want_qkv, want_table = wk.window_attention_backward_plain(
            grad.float(), q32, out.float(), rest.float(), lse, h, table, full, regions)
        errs = {key: float((got.float() - w).abs().max()) / float(w.abs().max())
                for key, got, w in (("out", out, want), ("grad_qkv", grad_qkv, want_qkv),
                                    ("grad_table", grad_table, want_table))}
        tols = {"out": 2 ** -8, "grad_qkv": 2 ** -8, "grad_table": 2 ** -8}
        row = {"windows": n, "heads": h, "tokens": length, "dtype": "bfloat16",
               "max_err_rel_to_max": errs, "tolerance": tols}
        del q32, want, want_lse, want_qkv, want_table
        if any(errs[k] > tols[k] for k in errs):
            raise AssertionError(f"window_attention {name} disagrees with its plain version: "
                                 f"{row}")
        index = wk.relative_position_index(full, dev)[:length, :length].reshape(-1)
        mask = wk.region_mask(regions, torch.bfloat16)

        def library_forward(x, t):
            bias = wk.dense_bias(wk.WindowBias(t, full, index, regions, mask), length,
                                 torch.bfloat16)
            return att.attention(x, h, bias)

        leaf, table_leaf = qkv.detach().requires_grad_(), table.detach().requires_grad_()
        library_out = library_forward(leaf, table_leaf)
        fns = {
            "fwd": lambda: torch.ops.asltpu_torch.window_attention(qkv, h, table, list(full),
                                                                   regions),
            "bwd": lambda: wk.window_attention_kernel_backward(grad, qkv, out, rest, lse, h,
                                                               table, full, regions),
            "library_fwd": lambda: library_forward(qkv, table),
            "library_bwd": lambda: torch.autograd.grad(library_out, (leaf, table_leaf), grad,
                                                       retain_graph=True),
            "plain_fwd": lambda: wk.window_attention_plain(qkv, h, table, full, regions),
            "plain_bwd": lambda: wk.window_attention_backward_plain(grad, qkv, out, rest, lse,
                                                                    h, table, full, regions),
        }
        ms = {}
        for key in ("library_fwd", "fwd", "fwd", "library_fwd", "library_bwd", "bwd", "bwd",
                    "library_bwd", "plain_fwd", "plain_bwd"):
            ms.setdefault(key, []).append(time_ms(fns[key], WINDOW_REPS))
        del library_out, leaf, table_leaf
        # q·kᵀ and P·v forward; backward 2.5 times (S and dP again, dv, dq, dk).
        flops_fwd = 2 * 2 * n * h * length * length * 32
        flops_bwd = flops_fwd * 5 // 2
        row.update({
            "ms_fwd": min(ms["fwd"]), "ms_bwd": min(ms["bwd"]),
            "library_ms_fwd": min(ms["library_fwd"]), "library_ms_bwd": min(ms["library_bwd"]),
            "plain_ms_fwd": ms["plain_fwd"][0], "plain_ms_bwd": ms["plain_bwd"][0],
            "ms_runs": ms, "flops_fwd": flops_fwd, "flops_bwd": flops_bwd,
            "bound_ms_fwd": flops_fwd / PEAK_BF16_FLOP_PER_S * 1e3,
            "bound_ms_bwd": flops_bwd / PEAK_BF16_FLOP_PER_S * 1e3,
            "library": "table gathered, cast, + mask, repeated over the clips and padded; "
                       "memory-efficient SDPA; autograd's backward to qkv and the table"})
        row["share_of_bound"] = ((row["bound_ms_fwd"] + row["bound_ms_bwd"])
                                 / (row["ms_fwd"] + row["ms_bwd"]))
        rows[name] = row
        del qkv, table, grad, out, rest, lse, grad_qkv, grad_table
        torch.cuda.empty_cache()
    emit({"phase": "window_attention", "layers": rows,
          "peaks": {"bf16_flop_per_s": PEAK_BF16_FLOP_PER_S, "source": "H100 SXM data sheet"}})
    return rows


def phase_bench():
    """The port's bench in this process, over its cells, with a short
    stream and ``--trace``; every video cell's rgb or yuv420 kernel must have
    launched, and the train cell's once a step. The two ``mobilenet_gru``
    cells' 640×480 streams must give ``predict``'s top-1, and each one's
    capture must hold its lane kernel's CUDA events, one per predict of
    the stream (as the kernel's count). Then the train step's timings and
    the 640×480 numbers (decode by backend and by worker count, the fit,
    mp4 → logits, the gate) and each captured stream's device busy share,
    each on a line of its own. Returns the kernels' launches in the 640×480
    streams, by path."""
    from asltpu_torch import benchmark

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as trace:
        result = benchmark.run(BENCH_ARGS + ["--trace", trace])
    launches = {}
    for cell in result["cells"]:
        if cell["lane"] == "train":
            if cell["kernel_launches_per_step"] != 1:
                raise AssertionError(f"bench i3d/train {cell['config']}: "
                                     f"{cell['kernel_launches_per_step']} kernel launches a step")
            continue
        if cell["device_only"]["kernel"] is None:
            continue  # pose_bilstm: no preprocess
        if cell["device_only"]["kernel_launches_per_predict"] < 1:
            raise AssertionError(f"bench {cell['family']}/{cell['lane']}: "
                                 "the preprocess kernel did not launch")
        if (cell["family"], cell["lane"]) not in benchmark.REALISTIC_CELLS:
            continue
        real = cell["realistic"]
        stream = real["mp4_stream"]
        kernel = benchmark.KERNELS[cell["lane"]]
        counts = (stream["trace"]["kernel_events"], stream["kernel_launches"])
        if (stream["kernel"] != kernel or not stream["top1_equal_predict"]
                or counts != (stream["predict_calls"],) * 2):
            raise AssertionError(
                f"bench realistic {cell['lane']}: {kernel} CUDA events in the trace and "
                f"launches {counts} for {stream['predict_calls']} predicts, top-1 equal "
                f"{stream['top1_equal_predict']}")
        launches[f"bench/realistic_{cell['lane']}"] = stream["kernel_launches"]
    emit({"phase": "bench", "args": BENCH_ARGS, **result})
    # The train step's timings, each on a line of its own: the production
    # configuration (batch 8, remat on) of the bench's i3d/train cell.
    cell = next(c for c in result["cells"] if c["lane"] == "train" and c["remat"])
    print(f"train step ms (cuda events, median, batch {cell['batch']}, remat on): "
          f"{cell['ms_per_step']}", flush=True)
    print(f"train clips/s: {cell['clips_per_s']}", flush=True)
    print(f"train peak GB: {cell['peak_mem_gb']}", flush=True)
    print(f"train GFLOP per clip (forward + backward): {cell['gflops_per_clip']} "
          f"(remat recompute {cell['recompute_gflops_per_clip']} apart)", flush=True)
    print(f"train MFU: {cell['mfu']}", flush=True)
    for cell in result["cells"]:
        name = f"{cell['family']}/{cell['lane']}"
        if "realistic" in cell:
            _print_realistic(name, cell["realistic"])
        for row, r in cell.get("mp4_stream", {}).items():
            if isinstance(r, dict) and "trace" in r:
                _print_trace(f"{name} mp4_stream {row} ({r['backend']})", r)
        for row in ("mp4_stream", "mp4_stream_fast"):
            r = cell.get("realistic", {}).get(row, {})
            if "trace" in r:
                _print_trace(f"{name} realistic {row} ({r['backend']})", r)
    return launches


def _print_realistic(name, real):
    """The 640×480 block's numbers of one bench cell, a line each."""
    size = "x".join(map(str, real["clip"]["size"]))
    rows = []
    for row, r in real["decode_only"].items():
        if row == "process":
            rows += [f"process {w} workers {v}" for w, v in r["clips_per_s_by_workers"].items()]
        elif isinstance(r, dict):
            rows.append(f"{row} {r['clips_per_s'] if r['ran'] else 'not run: ' + r['why']}")
    print(f"bench {name} {size} decode clips/s by backend: " + ", ".join(rows), flush=True)
    sc = real["scaling"]
    print(f"bench {name} {size} decode clips/s by workers ({sc['backend']}): "
          f"{sc['clips_per_s_by_workers']}; fit {sc['fit']}: r1 "
          f"{sc['r1_clips_per_s_per_worker']} (from {sc['r1_from_workers']} workers), "
          f"device_rate {sc['device_rate_clips_per_s']}, fit by workers "
          f"{sc['fit_clips_per_s_by_workers']}, projected workers for the device rate "
          f"{sc['projected_workers_for_device_rate']}", flush=True)
    for row in ("mp4_stream", "mp4_stream_fast"):
        r = real[row]
        if not r.get("clips_per_s"):
            print(f"bench {name} {size} {row}: not run: {r['why']}", flush=True)
            continue
        retry = (f", retried after {r['retry_trigger']} (first windows "
                 f"{r['first_attempt_windows']})" if "retry_trigger" in r else "")
        print(f"bench {name} {size} {row} mp4 -> logits clips/s (median window, "
              f"{r['backend']}, fast_flags {r['fast_flags']}): {r['clips_per_s']} (overall "
              f"{r['overall_clips_per_s']}, fill {r['fill_s']} s, windows "
              f"{r['window_clips_per_s']}, top-1 equal predict {r['top1_equal_predict']}, "
              f"largest logit gap {r['max_logit_err_vs_predict']}{retry})", flush=True)
    print(f"bench {name} decode_fast_gate: {json.dumps(real['decode_fast_gate'])}", flush=True)


def _print_trace(what, r):
    t = r["trace"]
    print(f"bench trace {what}: device busy share {t['busy_share']} "
          f"({t['device_busy_ms']} of {t['span_ms']} ms), {r['kernel']} CUDA events "
          f"{t['kernel_events']} for {r['predict_calls']} predicts", flush=True)


# Phase serve: the HTTP server at full width (module docstring, phase 16).
SERVE_BUCKETS = (1, 4, 8, 32)
SERVE_CLIPS = 12
# A served response against ``predict`` on its own clip, same bf16 model on
# the card: the preprocess is per pixel and bit-exact, so the two can
# differ only where cuDNN or cuBLAS takes another algorithm for another
# batch size (16 frames against a bucket's 16-512) and a bf16 rounding
# flips. The lanes' bound for logits that differ by a bf16 rounding here
# and there (LANE_LOGIT_ATOL). The logits of the served clips must spread
# over SERVE_SPREAD_FACTOR times it, and any two clips' logits differ by
# more than twice it, so that a response delivered to the wrong request
# fails.
SERVE_LOGIT_ATOL = LANE_LOGIT_ATOL
SERVE_SPREAD_FACTOR = 10
# A window's softmax probability moves by at most half the largest change
# of its logits (to first order).
SERVE_PROB_ATOL = SERVE_LOGIT_ATOL / 2
# The wire rounds logits and probabilities to 1e-4: a served value lies
# within half a step of the unrounded one.
SERVE_WIRE_STEP = 5e-5
SERVE_SESSION = dict(num_frames=250, fps=25)  # 10 s of untrimmed video
SERVE_WINDOW_QUERY = "window_s=2.0&stride_s=1.0"
# The full-width fusion, pose and yuv420 servers: small buckets, a few
# requests each.
SERVE_SMALL = dict(max_batch=4, batch_buckets=(1, 4))


def _http(base, path, body=None):
    """(status, JSON) of one request to the server at ``base``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_all(base, path, bodies):
    """POST every body at once, one client thread each; the (status, JSON)
    answers in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(lambda b: _http(base, path, b), bodies))


def _npy(a) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, np.asarray(a))
    return buf.getvalue()


def _top5_err(answer, logits) -> float:
    """Largest distance of a response's top-5 logits from ``logits`` at the
    same ids (the response's glosses are ids: no names)."""
    status, body = answer
    if status != 200:
        raise AssertionError(f"served request failed: {status} {body}")
    return max(abs(e["logit"] - float(logits[e["gloss"]])) for e in body["top5"])


def _served_vs_predict(answers, logits_list, atol):
    """Each response against ``predict``'s logits of its own input: top-5
    logits within ``atol``, the same gloss wherever predict's margin
    exceeds twice that. Returns (max error, clips under the top-1 rule)."""
    errs, covered = [], 0
    for answer, logits in zip(answers, logits_list):
        errs.append(_top5_err(answer, logits))
        top2 = np.sort(logits)[-2:]
        if top2[1] - top2[0] > 2 * atol:
            covered += 1
            if answer[1]["gloss"] != int(np.argmax(logits)):
                raise AssertionError(f"served gloss {answer[1]['gloss']} != predict's "
                                     f"{int(np.argmax(logits))} (margin {top2[1] - top2[0]})")
    if max(errs) > atol + SERVE_WIRE_STEP:
        raise AssertionError(f"served top-5 logits {max(errs)} from predict's (bound {atol} "
                             "and the wire's rounding)")
    return max(errs), covered


def _stop(httpd, predictor) -> None:
    """Stop a server started with ``block=False``: its HTTP loop, its socket
    and its batcher thread, which must end."""
    import threading

    httpd.shutdown()
    httpd.server_close()
    predictor.shutdown()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            t.name in ("asltpu_torch-http", "asltpu_torch-serve") and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    left = [t.name for t in threading.enumerate()
            if t.name in ("asltpu_torch-http", "asltpu_torch-serve") and t.is_alive()]
    if predictor._thread.is_alive() or left:
        raise AssertionError(f"server threads still running after shutdown: {left}")


def _calibrated(family, staged, **overrides):
    """``load_model(family, **overrides)`` at full width (bf16) with every
    BatchNorm's statistics calibrated through its backbone on ``staged``,
    uint8 clips of the kind it will serve, so that its logits vary from
    clip to clip."""
    from asltpu_torch import api
    from asltpu_torch.benchmark import backbone_and_head
    from asltpu_torch.ops.preprocess import preprocess_clip

    model = api.load_model(family, seed=SEED, **overrides)
    with torch.inference_mode():
        calib = preprocess_clip(torch.from_numpy(staged).to(model.device),
                                model.cfg.preprocess)
    calibrate_bn(model.module, calib, backbone_and_head(model.module)[0])
    return model


def _copy_share(model, clip) -> dict:
    """The host → device copy's share of a served batch, per bucket: the
    batcher's steps (pageable copy of the padded uint8 batch, predict,
    logits back) on the host clock after a synchronise, median of 5."""
    import statistics

    fn = model.predict_fn()
    out = {}
    for b in SERVE_BUCKETS:
        batch = np.repeat(clip[None], b, axis=0)
        copies, totals = [], []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = torch.from_numpy(batch).to(model.device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn(x).cpu().numpy()
            t2 = time.perf_counter()
            if i >= 2:
                copies.append(t1 - t0)
                totals.append(t2 - t0)
        copy_ms, batch_ms = 1e3 * statistics.median(copies), 1e3 * statistics.median(totals)
        out[str(b)] = {"copy_ms": copy_ms, "batch_ms": batch_ms, "copy_share": copy_ms / batch_ms,
                       "copy_mb": batch.nbytes / 1e6}
    return out


def phase_serve():
    """Serving at full width through ``asltpu_torch.serve_http.serve``:
    ``mobilenet_gru`` (rgb lane, calibrated BN) answering real HTTP
    requests from concurrent clients on /predict and /predict_windows, the
    fusion model on /predict_fusion, the pose model on /predict_landmarks
    and /predict_windows_landmarks, a yuv420-staged server on /predict;
    each response against ``predict`` (or ``predict_windows[_landmarks]``)
    on the same input and model. Then the serving latencies and clips/s at
    concurrency 1, 4 and 32 (``asltpu_torch.benchmark.serve_curve``) and
    the copy's share of a batch. Returns the kernels' launches per path."""
    from asltpu_torch import api
    from asltpu_torch.benchmark import serve_curve
    from asltpu_torch.data.decode import decode_record, probe_video
    from asltpu_torch.data.synthetic import synthetic_landmarks, write_video
    from asltpu_torch.data.wlasl import ClipRecord
    from asltpu_torch.ops import preprocess_kernels as k
    from asltpu_torch.serve_http import serve
    from asltpu_torch.windows import _resolve_plan, predict_windows, predict_windows_landmarks

    t_phase = time.perf_counter()
    launches, result = {}, {}
    with tempfile.TemporaryDirectory(prefix="asltpu_torch_serve_") as d:
        paths = []
        for i in range(SERVE_CLIPS):
            paths.append(os.path.join(d, f"clip{i:02d}.mp4"))
            write_video(paths[-1], num_frames=40, size=(240, 320), seed=SEED + 100 + i)
        calib_paths = []
        for i in range(8):
            calib_paths.append(os.path.join(d, f"calib{i}.mp4"))
            write_video(calib_paths[-1], num_frames=40, size=(240, 320), seed=SEED + 200 + i)
        calib = np.stack([api.load_clip(p) for p in calib_paths])
        session = os.path.join(d, "session.mp4")
        write_video(session, size=(240, 320), seed=SEED + 99, **SERVE_SESSION)
        bodies = []
        for p in paths + [session]:
            with open(p, "rb") as f:
                bodies.append(f.read())

        # mobilenet_gru, rgb lane: /predict from concurrent clients, then
        # /predict_windows on the untrimmed session.
        model = _calibrated("mobilenet_gru", calib)
        for key, want in FAMILIES["mobilenet_gru"]["config"].items():
            assert getattr(model.cfg, key) == want, key
        t0 = time.perf_counter()
        httpd, predictor = serve(model, host="127.0.0.1", port=0, block=False, max_batch=32,
                                 batch_buckets=SERVE_BUCKETS, warm=True)
        warm_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            torch.cuda.synchronize()
            k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
            answers = _post_all(base, "/predict", bodies[:SERVE_CLIPS])
            win_status, win_body = _http(base, f"/predict_windows?{SERVE_WINDOW_QUERY}",
                                         bodies[-1])
            torch.cuda.synchronize()
            launches["mobilenet_gru/serve"] = k.preprocess_rgb.launches
            stats = _http(base, "/stats")[1]
        finally:
            _stop(httpd, predictor)
        if launches["mobilenet_gru/serve"] < 1 or k.preprocess_yuv420.launches:
            raise AssertionError(f"serve: rgb kernel launches {launches}")
        if stats["avg_batch_size"] <= 1:
            raise AssertionError(f"serve: no batching under concurrent requests: {stats}")
        clips = [api.load_clip(p, model.cfg.preprocess) for p in paths]
        want = [api.predict(model, c)[1] for c in clips]
        spread = float(np.abs(np.stack(want) - np.stack(want).mean(0)).max())
        pairwise = min(float(np.abs(a - b).max()) for i, a in enumerate(want)
                       for b in want[i + 1:])
        err, covered = _served_vs_predict(answers, want, SERVE_LOGIT_ATOL)
        if spread < SERVE_SPREAD_FACTOR * SERVE_LOGIT_ATOL or pairwise <= 2 * SERVE_LOGIT_ATOL:
            raise AssertionError(f"serve: logits spread {spread} < {SERVE_SPREAD_FACTOR} x "
                                 f"{SERVE_LOGIT_ATOL} or two clips' logits within twice it "
                                 f"({pairwise}; max top-5 logit err {err})")
        # Windows: the same spans as predict_windows, the same ids wherever
        # the window's margin (its logits through predict) allows.
        wins = predict_windows(model, session, window_seconds=2.0, stride_seconds=1.0)
        total, fps = probe_video(session)
        spans = _resolve_plan(total, fps, 2.0, None, 1.0, None)
        _, win_logits = api.predict(model, np.stack([decode_record(ClipRecord(
            video_id=f"w{s}", gloss="", label=-1, split="", path=session, frame_start=s,
            frame_end=e), model.cfg.preprocess) for s, e in spans]))
        if win_status != 200 or win_body["num_windows"] != len(wins) or [
                (w["start_s"], w["end_s"]) for w in win_body["windows"]] != [
                (round(w.start_s, 3), round(w.end_s, 3)) for w in wins]:
            raise AssertionError(f"serve windows: {win_status} {win_body} vs {wins}")
        prob_err = max(abs(w["prob"] - x.prob) for w, x in zip(win_body["windows"], wins))
        top2 = np.sort(win_logits, axis=-1)[:, -2:]
        win_covered = top2[:, 1] - top2[:, 0] > 2 * SERVE_LOGIT_ATOL
        bad = [i for i, (w, x) in enumerate(zip(win_body["windows"], wins))
               if win_covered[i] and w["gloss"] != x.gloss_id]
        if prob_err > SERVE_PROB_ATOL + SERVE_WIRE_STEP or bad:
            raise AssertionError(f"serve windows vs predict_windows: prob err {prob_err}, "
                                 f"other gloss at windows {bad}")
        result["mobilenet_gru"] = {
            "buckets": list(SERVE_BUCKETS), "warm_s": warm_s, "requests": SERVE_CLIPS,
            "clip": "40 frames of 320x240 mp4", "launches": launches["mobilenet_gru/serve"],
            "max_top5_logit_err_vs_predict": err, "atol": SERVE_LOGIT_ATOL,
            "logit_spread": spread, "min_pairwise_logit_distance": pairwise,
            "top1_rule_clips": covered,
            "distinct_top1": len({int(np.argmax(w)) for w in want}), "stats": stats,
            "windows": {"query": SERVE_WINDOW_QUERY, "num_windows": len(wins),
                        "max_prob_err_vs_predict_windows": prob_err, "atol": SERVE_PROB_ATOL,
                        "top1_rule_windows": int(win_covered.sum()),
                        "segments": len(win_body["segments"])}}
        # The timings, on the same model: the closed-loop points, and the
        # copy's share of a batch per bucket.
        curve = serve_curve(model, clips[0], 32)
        share = _copy_share(model, clips[0])
        del model, clips
        torch.cuda.empty_cache()

        # two_stream on /predict_fusion with seeded landmarks.
        fusion = _calibrated("two_stream", calib)
        lm = synthetic_landmarks(3, fusion.cfg.preprocess.num_frames, seed=SEED + 11)
        httpd, predictor = serve(fusion, host="127.0.0.1", port=0, block=False, warm=True,
                                 **SERVE_SMALL)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            torch.cuda.synchronize()
            k.preprocess_rgb.launches = 0
            answers = _post_all(base, "/predict_fusion", [
                len(b).to_bytes(8, "big") + b + _npy(x) for b, x in zip(bodies[:3], lm)])
            torch.cuda.synchronize()
            launches["two_stream/serve"] = k.preprocess_rgb.launches
        finally:
            _stop(httpd, predictor)
        want = [api.predict(fusion, api.load_clip(p, fusion.cfg.preprocess), x)[1]
                for p, x in zip(paths[:3], lm)]
        err, covered = _served_vs_predict(answers, want, SERVE_LOGIT_ATOL)
        result["two_stream"] = {"requests": 3, "launches": launches["two_stream/serve"],
                                "max_top5_logit_err_vs_predict": err, "top1_rule_clips": covered}
        del fusion
        torch.cuda.empty_cache()

        # A yuv420-staged mobilenet_gru server on /predict.
        yuv = api.load_model("mobilenet_gru", seed=SEED, preprocess=dict(YUV_LANE))
        httpd, predictor = serve(yuv, host="127.0.0.1", port=0, block=False, warm=True,
                                 **SERVE_SMALL)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            torch.cuda.synchronize()
            k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
            answers = _post_all(base, "/predict", bodies[:3])
            torch.cuda.synchronize()
            launches["mobilenet_gru/serve_yuv420"] = k.preprocess_yuv420.launches
            if k.preprocess_rgb.launches:
                raise AssertionError("serve_yuv420: the rgb kernel launched")
        finally:
            _stop(httpd, predictor)
        want = [api.predict(yuv, api.load_clip(p, yuv.cfg.preprocess))[1] for p in paths[:3]]
        err, _ = _served_vs_predict(answers, want, SERVE_LOGIT_ATOL)
        result["mobilenet_gru_yuv420"] = {"requests": 3,
                                          "launches": launches["mobilenet_gru/serve_yuv420"],
                                          "max_top5_logit_err_vs_predict": err}
        del yuv
        torch.cuda.empty_cache()

    # pose_bilstm on /predict_landmarks and /predict_windows_landmarks.
    pose = api.load_model("pose_bilstm", seed=SEED)
    t = pose.cfg.num_frames
    lm = synthetic_landmarks(3, t, seed=SEED + 12)
    stream = synthetic_landmarks(1, SERVE_SESSION["num_frames"], seed=SEED + 13)[0]
    httpd, predictor = serve(pose, host="127.0.0.1", port=0, block=False, warm=True,
                             **SERVE_SMALL)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        answers = _post_all(base, "/predict_landmarks", [_npy(x) for x in lm])
        win_status, win_body = _http(
            base, f"/predict_windows_landmarks?{SERVE_WINDOW_QUERY}&fps=25", _npy(stream))
    finally:
        _stop(httpd, predictor)
    want = [api.predict(pose, x)[1] for x in lm]
    err, covered = _served_vs_predict(answers, want, POSE_CPU_ATOL)
    wins = predict_windows_landmarks(pose, stream, 25.0, window_seconds=2.0,
                                     stride_seconds=1.0)
    if win_status != 200 or [w["gloss"] for w in win_body["windows"]] != [
            w.gloss_id for w in wins]:
        raise AssertionError(f"serve pose windows: {win_status} {win_body} vs {wins}")
    prob_err = max(abs(w["prob"] - x.prob) for w, x in zip(win_body["windows"], wins))
    if prob_err > POSE_CPU_ATOL + SERVE_WIRE_STEP:
        raise AssertionError(f"serve pose windows: prob err {prob_err}")
    result["pose_bilstm"] = {"requests": 3, "max_top5_logit_err_vs_predict": err,
                             "atol": POSE_CPU_ATOL, "windows": len(wins),
                             "max_window_prob_err": prob_err}
    del pose
    torch.cuda.empty_cache()
    emit({"phase": "serve", **result, "launches_by_path": launches, "timing": curve,
          "copy_share_by_bucket": share, "seconds": time.perf_counter() - t_phase})
    return launches, curve, share


# Phase export: each config's inference program exported with
# ``asltpu_torch.export`` at full width (module docstring, phase 17).
EXPORT_CASES = (
    ("mobilenet_gru/rgb", "mobilenet_gru", RGB_LANE),
    ("mobilenet_gru/yuv420", "mobilenet_gru", YUV_LANE),
    ("resnet_transformer/rgb", "resnet_transformer", RGB_LANE),
    ("i3d/rgb", "i3d", RGB_LANE),
    ("two_stream/rgb", "two_stream", RGB_LANE),
    ("pose_bilstm/landmarks", "pose_bilstm", None),
)
# Runs in a fresh interpreter: loads each artifact of the directory argv[1]
# with no model code, runs its inputs through it (the kernels' launches
# counted per artifact) and prints what it saw as the last line.
EXPORT_LOADER = """
import json, sys
import numpy as np, torch
from asltpu_torch.export import load_exported
from asltpu_torch.ops import pool3d_kernels as pk, preprocess_kernels as k
d = sys.argv[1]
runs = {}
for name in json.load(open(d + "/cases.json")):
    em = load_exported(d + "/" + name)
    with np.load(d + "/" + name + ".npz") as z:
        inputs = {key: z[key] for key in z.files}
    torch.cuda.synchronize()
    k.preprocess_rgb.launches = k.preprocess_yuv420.launches = 0
    pk.max_pool3d_same.launches = pk.max_pool3d_same_backward.launches = 0
    logits = em.predict_batch(**inputs)
    torch.cuda.synchronize()
    np.save(d + "/" + name + ".logits.npy", logits)
    runs[name] = {"preprocess_rgb": k.preprocess_rgb.launches,
                  "preprocess_yuv420": k.preprocess_yuv420.launches,
                  "max_pool3d_same": pk.max_pool3d_same.launches,
                  "max_pool3d_same_backward": pk.max_pool3d_same_backward.launches,
                  "preprocess": em.meta["preprocess"], "device": str(em.device)}
model_code = sorted(m for m in sys.modules
                    if m.startswith(("asltpu_torch.models", "asltpu_torch.api")))
print(json.dumps({"runs": runs, "model_modules": model_code}))
"""


def _export_inputs(family, cfg, batch):
    """Seeded inputs of one exported program: varied staged clips and/or
    landmarks."""
    from asltpu_torch.data.synthetic import synthetic_landmarks

    inputs = {}
    if family != "pose_bilstm":
        pp = cfg.preprocess
        inputs["frames"] = _varied_clips(SEED + 31, batch, pp.num_frames,
                                         pp.staged_frame_shape)
    if family in ("pose_bilstm", "two_stream"):
        t = cfg.preprocess.num_frames if family == "two_stream" else cfg.num_frames
        inputs["landmarks"] = synthetic_landmarks(batch, t, seed=SEED + 32)
    return inputs


def phase_export():
    """Export each config at full width on the card (random weights from
    the seed, BatchNorm calibrated on varied clips), load every artifact in
    a fresh process that imports no model code, and hold its logits to the
    live ``predict_fn``'s; the kernels' launches inside the exported
    programs; exported and live device ms by CUDA events, in turns. Returns
    the preprocess kernels' launches by path and the max-pool kernels'
    [forward, backward] by path."""
    import subprocess

    from asltpu_torch import api
    from asltpu_torch.export import export_model, load_exported

    t_phase = time.perf_counter()
    rows, live_logits = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for path, family, pp in EXPORT_CASES:
            name = path.replace("/", "-")
            if family == "pose_bilstm":
                model, batch = api.load_model(family, seed=SEED), POSE_BATCH
            else:
                batch = FAMILIES[family]["batch"]
                staging = api.get_config(family, preprocess=dict(pp)).preprocess
                calib = _varied_clips(SEED + 30, 8, staging.num_frames,
                                      staging.staged_frame_shape)
                model = _calibrated(family, calib, preprocess=dict(pp))
            inputs = _export_inputs(family, model.cfg, batch)
            np.savez(os.path.join(d, name + ".npz"), **inputs)
            t0 = time.perf_counter()
            meta = export_model(model, os.path.join(d, name), batch_size=batch)
            export_s = time.perf_counter() - t0
            xs = [torch.from_numpy(a).to(model.device) for a in inputs.values()]
            live = model.predict_fn()
            live_logits[name] = live(*xs).cpu().numpy()
            exported = load_exported(os.path.join(d, name))
            graph = exported.program.graph
            fn = exported.program.module()

            def run_exported():
                with torch.inference_mode():
                    return fn(*xs)

            # Device time in turns: live, exported, exported, live.
            ms = [time_ms(f, PREDICT_REPS)
                  for f in (lambda: live(*xs), run_exported, run_exported, lambda: live(*xs))]
            rows[name] = {
                "path": path, "batch": batch, "export_s": export_s,
                "preprocess": meta["preprocess"], "inputs": meta["inputs"],
                "graph_nodes": len(graph.nodes),
                "rnn_ops": sorted({str(n.target) for n in graph.nodes
                                   if n.op == "call_function"
                                   and any(w in str(n.target) for w in ("lstm", "gru", "rnn"))}),
                "live_ms": min(ms[0], ms[3]), "exported_ms": min(ms[1], ms[2]),
                "ms_in_turns": ms,
            }
            del model, live, exported, fn, xs
            torch.cuda.empty_cache()
        with open(os.path.join(d, "cases.json"), "w") as f:
            json.dump(list(rows), f)
        proc = subprocess.run([sys.executable, "-c", EXPORT_LOADER, d],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"loading the artifacts in a fresh process failed:\n"
                                 f"{proc.stderr[-4000:]}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, row in rows.items():
            got = np.load(os.path.join(d, name + ".logits.npy"))
            want = live_logits[name]
            row.update(loaded["runs"][name])
            row["max_logit_err_vs_live"] = float(np.abs(got - want).max())
            row["logit_spread"] = float(np.abs(want - want.mean(0)).max())
    if loaded["model_modules"]:
        raise AssertionError(f"loading the artifacts imported model code: "
                             f"{loaded['model_modules']}")
    launches, pools = {}, {}
    for name, row in rows.items():
        lane = "preprocess_yuv420" if name.endswith("yuv420") else "preprocess_rgb"
        want_op = None if name.startswith("pose") else "asltpu_torch::" + lane
        pools[f"export/{row['path']}"] = [row["max_pool3d_same"],
                                          row["max_pool3d_same_backward"]]
        want_pools = [I3D_POOLS if name.startswith("i3d") else 0, 0]
        if (row["max_logit_err_vs_live"] > LANE_LOGIT_ATOL or row["preprocess"] != want_op
                or (want_op and row[lane] < 1) or pools[f"export/{row['path']}"] != want_pools):
            raise AssertionError(f"export {row['path']}: {row}")
        if want_op:
            launches[f"export/{row['path']}"] = row[lane]
    emit({"phase": "export", "atol": LANE_LOGIT_ATOL, "cases": rows,
          "loader_model_modules": loaded["model_modules"],
          "seconds": time.perf_counter() - t_phase})
    for row in rows.values():
        print(f"export {row['path']} (batch {row['batch']}): exported {row['exported_ms']} ms, "
              f"live {row['live_ms']} ms a batch (cuda events); max logit gap "
              f"{row['max_logit_err_vs_live']}", flush=True)
    return launches, pools


# Phase learn: the learning proofs through the CLI and the library
# (module docstring, phase 18), with the JAX package's thresholds
# (tests/integration/test_learning.py).
LEARN_TOP1 = {"mobilenet_gru": 0.8, "pose_bilstm": 0.9, "two_stream": 0.75}
LEARN_SMALL = ["--num-classes", "6", "--set", "width_mult=0.5", "--set", "gru_hidden=32"]
# The model the CLI trains at --frames 4 --crop 32, for eval, export, predict.
LEARN_MODEL = [*LEARN_SMALL, "--set", "preprocess.num_frames=4",
               "--set", "preprocess.crop=32", "--set", "preprocess.resize_short=37",
               "--set", "preprocess.staging_size=(37,37)"]
LEARN_WORKERS = 4
FULL_TRAIN_STEPS = 12


def _cli(argv):
    """``asltpu_torch.cli`` in this process; its JSON lines."""
    import contextlib
    import io

    from asltpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]


def _csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def _library_proof(name, cfg_kw, train_set, val_set, steps):
    """Train ``name`` through ``train()`` on seeded in-memory batches of 16
    (the JAX proof's loop), eval every 50 steps on the 24 val clips; the
    eval trajectory."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train.loop import train

    model = api.build_trainable(name, seed=SEED, **cfg_kw)
    *tr_x, tr_y = train_set
    *va_x, va_y = val_set

    def pick(xs, idx):
        return tuple(x[idx] for x in xs) if len(xs) > 1 else xs[0][idx]

    def batches():
        rng = np.random.default_rng(1)
        while True:
            idx = rng.choice(len(tr_y), 16, replace=False)
            yield pick(tr_x, idx), tr_y[idx]

    def eval_batches():
        for i in range(0, len(va_y), 16):
            yield pick(va_x, slice(i, i + 16)), va_y[i:i + 16]

    evals = []
    with tempfile.TemporaryDirectory() as ck:
        tcfg = TrainConfig(batch_size=16, num_steps=steps, warmup_steps=10, learning_rate=3e-3,
                           log_every=1000, eval_every=50, ckpt_every=100_000, ckpt_dir=ck)
        train(model.module, tcfg, batches(), eval_batches=eval_batches,
              metric_writer=lambda step, m: evals.append(
                  (step, m["eval_top1"], m["eval_clips"])) if "eval_top1" in m else None)
    if evals[-1][0] != steps or evals[-1][1] < LEARN_TOP1[name] or any(
            n != len(va_y) for _, _, n in evals):
        raise AssertionError(f"{name} did not learn: {evals}")
    return [(s, t) for s, t, _ in evals]


def phase_learn():
    """The learning proofs on the card: ``make_separable_wlasl`` → ``asl
    train`` (the JAX proof's arguments, the resumable loader with decode
    workers) → ``asl eval`` → ``asl export`` → ``asl predict --exported``
    against ``asl predict --ckpt``; the ``pose_bilstm`` and ``two_stream``
    proofs through ``train()``; then a few full-width ``asl train`` steps
    with decode workers, timed. Returns the rgb kernel's launches of the
    ``asl train`` runs."""
    from asltpu_torch.data import synthetic
    from asltpu_torch.ops import preprocess_kernels as k

    t_phase = time.perf_counter()
    out = {"phase": "learn"}
    with tempfile.TemporaryDirectory() as d:
        index, videos = synthetic.make_separable_wlasl(
            os.path.join(d, "data"), num_glosses=6, train_per_gloss=8, val_per_gloss=4,
            num_frames=24, size=(96, 96))
        ck, logs = os.path.join(d, "ck"), os.path.join(d, "logs")
        torch.cuda.synchronize()
        k.preprocess_rgb.launches = 0
        t0 = time.perf_counter()
        _cli(["train", "--model", "mobilenet_gru", *LEARN_SMALL, "--index", index,
              "--videos", videos, "--batch", "8", "--steps", "300", "--lr", "2e-3",
              "--warmup", "10", "--log-every", "50", "--eval-split", "val",
              "--eval-every", "75", "--ckpt-dir", ck, "--ckpt-every", "300",
              "--frames", "4", "--crop", "32", "--log-dir", logs,
              "--loader", "grain", "--loader-workers", str(LEARN_WORKERS)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = k.preprocess_rgb.launches
        rows = _csv(os.path.join(logs, "train_metrics_eval.csv"))
        traj = [(int(float(r["step"])), float(r["eval_top1"])) for r in rows]
        if (traj[-1][0] != 300 or traj[-1][1] < LEARN_TOP1["mobilenet_gru"]
                or any(float(r["eval_clips"]) != 24.0 for r in rows)):
            raise AssertionError(f"asl train mobilenet_gru did not learn: {traj}")
        out["mobilenet_gru"] = {"trajectory": traj, "train_s": train_s,
                                "loader_workers": LEARN_WORKERS}
        split = [ln for ln in _cli(["eval", "--model", "mobilenet_gru", *LEARN_MODEL,
                                    "--ckpt", ck, "--index", index, "--videos", videos,
                                    "--split", "val"])][0]
        if split["num_clips"] != 24.0 or split["top1"] < LEARN_TOP1["mobilenet_gru"]:
            raise AssertionError(f"asl eval of the trained checkpoint: {split}")
        art = os.path.join(d, "artifact")
        exp = _cli(["export", "--model", "mobilenet_gru", *LEARN_MODEL, "--ckpt", ck,
                    "--out", art, "--batch", "8"])[0]
        val_clip = os.path.join(videos, "00008.mp4")  # gloss 0's first val clip
        (by_export,) = _cli(["predict", "--exported", art, val_clip])
        (by_ckpt,) = _cli(["predict", "--model", "mobilenet_gru", *LEARN_MODEL, "--ckpt", ck,
                           val_clip])
        gap = max(abs(a["logit"] - b["logit"]) for a, b in zip(by_export["top5"],
                                                                by_ckpt["top5"]))
        if (exp["preprocess"] != "asltpu_torch::preprocess_rgb"
                or by_export["gloss"] != by_ckpt["gloss"]):
            raise AssertionError(f"train -> export -> predict --exported: {exp}, "
                                 f"{by_export} vs {by_ckpt}")
        out["chain"] = {"eval": split, "export": exp, "val_clip_gloss": by_export["gloss"],
                        "predict_exported_vs_ckpt_top5_gap": gap}

        out["pose_bilstm"] = _library_proof(
            "pose_bilstm", dict(num_classes=6, hidden_size=32, num_frames=16, dropout=0.1),
            synthetic.make_separable_landmarks(6, 8, num_frames=16, seed=0),
            synthetic.make_separable_landmarks(6, 4, num_frames=16, seed=7777), 150)
        out["two_stream"] = _library_proof(
            "two_stream", dict(num_classes=6, num_frames=4, d_model=32, num_heads=2,
                               num_fusion_layers=1, dropout=0.1, width_mult=0.5),
            synthetic.make_separable_fusion(3, 2, 8, num_frames=4, size=(32, 32), seed=0),
            synthetic.make_separable_fusion(3, 2, 4, num_frames=4, size=(32, 32), seed=7777),
            200)

        # Full width (the config's defaults: 16 frames of 256² staged,
        # crop 224, bf16 compute), decode workers feeding the steps.
        full_index, full_videos = synthetic.make_synthetic_wlasl(
            os.path.join(d, "full"), num_glosses=4, clips_per_gloss=8, num_frames=32,
            size=(256, 256))
        full_logs = os.path.join(d, "full_logs")
        torch.cuda.synchronize()
        k.preprocess_rgb.launches = 0
        _cli(["train", "--model", "mobilenet_gru", "--num-classes", "4", "--index", full_index,
              "--videos", full_videos, "--batch", "8", "--steps", str(FULL_TRAIN_STEPS),
              "--warmup", "1", "--log-every", "1", "--ckpt-dir", os.path.join(d, "full_ck"),
              "--ckpt-every", "1000", "--no-augment", "--log-dir", full_logs,
              "--loader", "grain", "--loader-workers", str(LEARN_WORKERS)])
        torch.cuda.synchronize()
        launches += k.preprocess_rgb.launches
        steps = _csv(os.path.join(full_logs, "train_metrics.csv"))
        # The first steps include cuDNN's autotuning and the workers' start.
        step_ms = [1e3 / float(r["steps_per_sec"]) for r in steps[4:]]
        out["full_width"] = {"steps": FULL_TRAIN_STEPS, "batch": 8, "augment": False,
                             "loader_workers": LEARN_WORKERS,
                             "ms_a_step_host_clock": step_ms,
                             "median_ms_a_step": float(np.median(step_ms)),
                             "launches": k.preprocess_rgb.launches}
    if launches < 1:
        raise AssertionError("the rgb kernel did not launch in asl train")
    out["launches_cli_train"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    print(f"learn: asl train mobilenet_gru top-1 {traj}; pose_bilstm {out['pose_bilstm']}; "
          f"two_stream {out['two_stream']}", flush=True)
    print(f"cli/train full width (batch 8, {LEARN_WORKERS} loader workers, no augment): "
          f"median {out['full_width']['median_ms_a_step']} ms a step (host clock, steps 5-"
          f"{FULL_TRAIN_STEPS})", flush=True)
    return launches


DIST_RANKS = 2
DIST_BATCH = 8  # global: 4 rows a rank
DIST_STEPS = 2
DIST_PREDICT = 16  # clips a rank in the sharded predict
DIST_GROUP_TIMEOUT_S = 60  # every process group's collective timeout
DIST_JOIN_TIMEOUT_S = 100  # the rank launch; each torchrun call: 90
# DP (and the one-rank NCCL group) against the single-process step at full
# width, each in fp32 and in bf16 (the main path's dtype). fp32: the loss of
# each step within 1e-4 (relative) and grad_norm within 1e-3. bf16: the DP
# BatchNorm is the port's own normalisation (global statistics by
# all-reduce) where the single step runs PyTorch's kernel; the two round
# their fp32 results to bf16 at a few other elements, and 52 training
# BatchNorms carry that through the net, as bf16 itself moves the single
# step from its fp32 twin. So each bf16 gap (loss, grad_norm) is held to
# three times that step's own bf16-vs-fp32 gap (and never below the fp32
# bound). Both: every running statistic within 1e-4 + 1e-2 of its tensor's
# largest entry (the means of a conv after a BatchNorm sit near 0, so a
# bound relative to the largest alone does not fit them); the parameters
# after the steps (warmup 1: one update at lr 1e-3) within the sign-flip
# bound of tests/unit/test_train.py:290-305, 2·lr times the largest
# bias-corrected Adam ratio of two steps, |m̂/√v̂| ≤ 1.00136 (0.9, 0.999).
DIST_LOSS_RTOL, DIST_NORM_RTOL, DIST_BF16_SLACK = 1e-4, 1e-3, 3.0
DIST_STAT_ATOL, DIST_STAT_RTOL = 1e-4, 1e-2
DIST_SIGN_FLIP = 2 * 1.00136 * 1e-3
# TP in fp32 against the replicated step: the fp32 bounds, and (as the JAX
# test of the tuple batch) under 0.5% of the parameters past 1e-4 of the
# replicated ones.
DIST_DRIFT, DIST_DRIFT_SHARE = 1e-4, 0.005
DIST_CLI = ["--model", "resnet_transformer", "--num-classes", "4", "--model-parallel", "2",
            "--dist-backend", "gloo", "--batch", str(DIST_BATCH), "--steps", "4",
            "--warmup", "1", "--log-every", "1", "--ckpt-every", "2", "--no-augment",
            "--loader", "grain"]


def _dist_batches(name, device):
    from asltpu_torch.config import get_config

    cfg = get_config(name)
    shape = (DIST_BATCH, cfg.preprocess.num_frames, *cfg.preprocess.staged_frame_shape)
    stream = SeededBatches(shape, cfg.num_classes, device, seed=SEED + 30)
    return [next(stream) for _ in range(DIST_STEPS)]


def _dist_steps(name, mesh=None, tp=False, **over):
    """``DIST_STEPS`` train steps of ``name`` at full width from the seed
    (warmup 1), on one process (no ``mesh``) or as this rank of ``mesh``
    (replicated from rank 0, sharded over the model axis with ``tp``): the
    losses, grad norms, host-clock step ms, rgb kernel launches, and the
    single-device state on the CPU."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.dist import replicate, tp_gather_state_dict, tp_shard_module
    from asltpu_torch.ops.preprocess_kernels import preprocess_rgb
    from asltpu_torch.train import loop

    model = api.build_trainable(name, seed=SEED, **over)
    if mesh is not None:
        replicate(model.module, mesh)
        if tp:
            tp_shard_module(model.module, mesh)
    tcfg = TrainConfig(batch_size=DIST_BATCH, num_steps=100, warmup_steps=1)
    state = loop.create_train_state(model.module, tcfg, SEED, mesh=mesh)
    step = loop.make_train_step(tcfg, model.cfg.preprocess, mesh=mesh)
    batches = _dist_batches(name, model.device)
    out = {"loss": [], "grad_norm": [], "ms": []}
    torch.cuda.synchronize()
    preprocess_rgb.launches = 0
    for b, y in batches:
        t0 = time.perf_counter()
        state, m = step(state, b, y)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["launches"] = preprocess_rgb.launches
    out["state"] = {k: v.detach().cpu() for k, v in
                    tp_gather_state_dict(model.module, mesh).items()}
    del model, state, batches
    torch.cuda.empty_cache()
    return out


def _dist_predict(mesh, sd_path, clips_path):
    """This rank's rows of the 32 calibrated clips through ``predict_fn``,
    gathered over the data group; the rgb kernel's launches."""
    from asltpu_torch import api
    from asltpu_torch.dist import gather_batch, shard_batch
    from asltpu_torch.ops.preprocess_kernels import preprocess_rgb

    model = api.load_model("mobilenet_gru", seed=SEED)
    model.module.load_state_dict(torch.load(sd_path, map_location="cuda"))
    frames = torch.from_numpy(shard_batch(mesh, np.load(clips_path))).cuda()
    fn = model.predict_fn()
    torch.cuda.synchronize()
    preprocess_rgb.launches = 0
    with torch.no_grad():
        logits = gather_batch(mesh, fn(frames).float())
    return {"logits": logits.cpu(), "launches": preprocess_rgb.launches,
            "local": list(frames.shape)}


def _dist_rank(rank, port, out):
    """A rank process of phase dist (``chip_smoke.py --dist-rank``): joins
    the gloo group of ``DIST_RANKS`` on cuda:0, runs (b) DP, (c) TP and (d)
    sharded predict, and saves what it got to ``out/rank<rank>.pt``."""
    from asltpu_torch.dist import init_distributed, make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", DIST_RANKS, rank, backend="gloo",
                     timeout_s=DIST_GROUP_TIMEOUT_S)
    dp = make_mesh()
    res = {"dp": _dist_steps("mobilenet_gru", dp),
           "dp_fp32": _dist_steps("mobilenet_gru", dp, compute_dtype="float32"),
           "tp": _dist_steps("resnet_transformer", make_mesh(model_parallel=DIST_RANKS),
                             tp=True, compute_dtype="float32"),
           "predict": _dist_predict(dp, os.path.join(out, "calibrated.pt"),
                                    os.path.join(out, "clips.npy"))}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _cli_rank(out, argv):
    """A rank of phase dist (e) under ``torch.distributed.run``
    (``chip_smoke.py --cli-rank OUT train ...``): ``asltpu_torch.cli``'s
    main on ``argv``, as ``python -m asltpu_torch.cli`` runs it, then this
    rank's rgb kernel launches written to ``OUT/cli<run>_rank<RANK>``."""
    from asltpu_torch.cli.main import main as cli_main
    from asltpu_torch.ops.preprocess_kernels import preprocess_rgb

    preprocess_rgb.launches = 0
    try:
        return cli_main(argv)
    finally:
        with open(f"{out}_rank{os.environ['RANK']}", "w") as f:
            f.write(str(preprocess_rgb.launches))


def _stat_excess(got, want) -> float:
    """How far ``got`` exceeds the statistics bound (≤ 0: inside it)."""
    bound = DIST_STAT_ATOL + DIST_STAT_RTOL * float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) - bound


def _rels(got, want, key):
    return [abs(a - b) / abs(b) for a, b in zip(got[key], want[key])]


def _compare_steps(got, want, what, fp32_twin=None, drift_share=None):
    """``got`` (a DP or TP run) against ``want`` (one process): the bounds
    above (bf16 where ``fp32_twin``, the single step in fp32, is given);
    returns the measured gaps."""
    loss_bound, norm_bound = [DIST_LOSS_RTOL] * DIST_STEPS, [DIST_NORM_RTOL] * DIST_STEPS
    gaps = {"loss_rel": _rels(got, want, "loss"), "grad_norm_rel": _rels(got, want, "grad_norm")}
    if fp32_twin is not None:
        loss_bound = [max(b, DIST_BF16_SLACK * g) for b, g in
                      zip(loss_bound, _rels(want, fp32_twin, "loss"))]
        norm_bound = [max(b, DIST_BF16_SLACK * g) for b, g in
                      zip(norm_bound, _rels(want, fp32_twin, "grad_norm"))]
        gaps.update(loss_bound=loss_bound, grad_norm_bound=norm_bound)
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    gaps["stat_excess"] = max((_stat_excess(got["state"][k], want["state"][k])
                               for k in stats), default=-1.0)
    total = drifted = 0
    worst = 0.0
    for k, v in want["state"].items():
        if k in stats or not v.is_floating_point():
            continue
        d = (got["state"][k] - v).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        drifted += int((d > DIST_DRIFT).sum())
    gaps.update(param_max_abs=worst, drifted_share=drifted / total)
    ok = (all(g <= b for g, b in zip(gaps["loss_rel"], loss_bound))
          and all(g <= b for g, b in zip(gaps["grad_norm_rel"], norm_bound))
          and gaps["stat_excess"] <= 0 and worst <= DIST_SIGN_FLIP
          and (drift_share is None or gaps["drifted_share"] < drift_share))
    if not ok:
        raise AssertionError(f"dist {what}: disagrees with one process: {gaps}")
    return gaps


def _dist_cli(tmp):
    """(e): ``asl train`` of the full-width ``resnet_transformer`` with
    ``--model-parallel 2`` under ``torch.distributed.run`` (2 gloo ranks on
    cuda:0), 4 steps on synthetic records with a fault at step 3, then a
    rerun that resumes from rank 0's step-2 checkpoint. Returns the rgb
    kernel's launches of both runs' ranks."""
    import signal
    import subprocess

    from asltpu_torch import ckpt
    from asltpu_torch.data.synthetic import make_synthetic_wlasl

    index, videos = make_synthetic_wlasl(os.path.join(tmp, "wlasl"), num_glosses=4,
                                         clips_per_gloss=4, num_frames=32, size=(256, 256),
                                         splits=["train"])
    ck = os.path.join(tmp, "cli_ck")
    launches = 0
    for run, fault in (("cut", "3"), ("resumed", "-1")):
        counts = os.path.join(tmp, f"cli_{run}")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(DIST_RANKS), os.path.abspath(__file__),
               "--cli-rank", counts, "train", *DIST_CLI, "--index", index, "--videos", videos,
               "--ckpt-dir", ck, "--fault-inject-step", fault]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            log = proc.communicate(timeout=90)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"dist cli_train {run}: no end in 90 s")
        if (proc.returncode != 0) != (run == "cut") or (
                run == "cut" and "FaultInjected" not in log):
            raise AssertionError(f"dist cli_train {run}: exit {proc.returncode}\n{log[-4000:]}")
        for r in range(DIST_RANKS):
            with open(f"{counts}_rank{r}") as f:
                launches += int(f.read())
        if run == "cut" and sorted(os.listdir(ck)) != ["2"]:
            raise AssertionError(f"dist cli_train: checkpoints after the fault: {os.listdir(ck)}")
    steps = sorted(d for d in os.listdir(ck) if d.isdigit())
    sd = ckpt.load_trained_state_dict(ck)
    if steps != ["2", "4"] or sd["head.layers.0.mlp1.weight"].shape != (2048, 512):
        raise AssertionError(f"dist cli_train: {steps}, "
                             f"{sd['head.layers.0.mlp1.weight'].shape}")
    return launches


def phase_dist():
    """Phase dist (module docstring): (a) a one-rank NCCL group, (b)-(d)
    two gloo ranks on cuda:0, (e) ``asl train --model-parallel 2`` under
    ``torch.distributed.run``. Returns the rgb kernel's launches by path."""
    import shutil
    import socket
    import subprocess

    import torch.distributed as dist

    from asltpu_torch import api
    from asltpu_torch.config import PreprocessConfig
    from asltpu_torch.dist import Mesh, init_distributed
    from asltpu_torch.ops.preprocess import preprocess_clip
    from asltpu_torch.ops.preprocess_kernels import preprocess_rgb

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="asltpu_smoke_dist_")
    try:
        # (d)'s inputs first, so the ranks can start: calibrated weights
        # (varied clips: at the seeded init the logits barely vary) and the
        # 32 clips.
        staged = PreprocessConfig().staged_frame_shape
        model = api.load_model("mobilenet_gru", seed=SEED)
        calib = torch.from_numpy(_varied_clips(SEED + 40, 8, 16, staged)).cuda()
        calibrate_bn(model.module, preprocess_clip(calib, model.cfg.preprocess))
        torch.save(model.module.state_dict(), os.path.join(tmp, "calibrated.pt"))
        clips = _varied_clips(SEED + 41, DIST_RANKS * DIST_PREDICT, 16, staged)
        np.save(os.path.join(tmp, "clips.npy"), clips)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(DIST_RANKS)]
        ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank",
                                   str(r), str(port), tmp], stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(DIST_RANKS)]
        try:
            with torch.no_grad():
                want_logits = model.predict_fn()(torch.from_numpy(clips).cuda()).float().cpu()
            del model, calib
            single = _dist_steps("mobilenet_gru")
            single32 = _dist_steps("mobilenet_gru", compute_dtype="float32")
            # (a) The same steps in a one-rank NCCL group: a mesh over its
            # world runs every DP collective (BatchNorm's, the gradient
            # all-reduce) through NCCL.
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                nccl_port = s.getsockname()[1]
            init_distributed(f"127.0.0.1:{nccl_port}", 1, 0, backend="nccl",
                             timeout_s=DIST_GROUP_TIMEOUT_S)
            try:
                one_rank = Mesh(data_group=dist.group.WORLD)
                nccl = _dist_steps("mobilenet_gru", one_rank)
                nccl32 = _dist_steps("mobilenet_gru", one_rank, compute_dtype="float32")
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
            replicated = _dist_steps("resnet_transformer", compute_dtype="float32")
            deadline = time.monotonic() + DIST_JOIN_TIMEOUT_S
            for p in ranks:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if any(p.returncode for p in ranks):
            tails = []
            for r in range(DIST_RANKS):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    tails.append(f"rank {r} exit {ranks[r].returncode}:\n{f.read()[-3000:]}")
            raise AssertionError("dist ranks failed:\n" + "\n".join(tails))
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(DIST_RANKS)]
        checks = {"backend_a": backend,
                  "a_nccl_bf16": _compare_steps(nccl, single, "(a) nccl bf16", single32),
                  "a_nccl_fp32": _compare_steps(nccl32, single32, "(a) nccl fp32"),
                  "b_dp_bf16": _compare_steps(got[0]["dp"], single, "(b) dp bf16", single32),
                  "b_dp_fp32": _compare_steps(got[0]["dp_fp32"], single32, "(b) dp fp32"),
                  "c_tp_fp32": _compare_steps(got[0]["tp"], replicated, "(c) tp",
                                              drift_share=DIST_DRIFT_SHARE)}
        for g in got[1:]:
            for part in ("dp", "dp_fp32", "tp"):
                if g[part]["loss"] != got[0][part]["loss"]:
                    raise AssertionError(f"dist {part}: the ranks' losses differ")
        logits = got[0]["predict"]["logits"]
        spread = float((want_logits - want_logits.mean(0)).abs().max())
        err = float((logits - want_logits).abs().max())
        checks["d_predict"] = {"max_abs_err": err, "spread": spread,
                               "rows_a_rank": got[0]["predict"]["local"][0]}
        if logits.shape != want_logits.shape or err > LANE_LOGIT_ATOL or (
                spread < VARIED_SPREAD_MIN):
            raise AssertionError(f"dist (d) sharded predict: {checks['d_predict']}")
        torch.cuda.synchronize()
        preprocess_rgb.launches = 0
        launches = {"dist/dp_train": nccl["launches"] + nccl32["launches"] + sum(
                        g["dp"]["launches"] + g["dp_fp32"]["launches"] for g in got),
                    "dist/tp_train": sum(g["tp"]["launches"] for g in got),
                    "dist/sharded_predict": sum(g["predict"]["launches"] for g in got),
                    "dist/cli_train": _dist_cli(tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    timing = {"single_dp_ms": single["ms"], "a_nccl_ms": nccl["ms"],
              "b_dp_ms": [g["dp"]["ms"] for g in got], "single_dp_fp32_ms": single32["ms"],
              "b_dp_fp32_ms": [g["dp_fp32"]["ms"] for g in got],
              "replicated_tp_ms": replicated["ms"],
              "c_tp_ms": [g["tp"]["ms"] for g in got]}
    emit({"phase": "dist", "checks": checks, "launches_by_path": launches,
          "timing_ms_host_clock": timing, "seconds": time.perf_counter() - t0})
    if min(launches.values()) < 1:
        raise AssertionError(f"dist: a path launched no rgb kernel: {launches}")
    return launches, timing


def _live_children() -> list:
    """(pid, command line) of this process's children that have not exited,
    from ``/proc``; exited ones (zombies) are reaped on the way."""
    me, out = os.getpid(), []
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit():
            continue
        try:
            with open(f"/proc/{entry.name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            if int(ppid) != me:
                continue
            if state == "Z":
                os.waitpid(int(entry.name), os.WNOHANG)
                continue
            with open(f"/proc/{entry.name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError):
            continue  # exited while we looked
        out.append((int(entry.name), cmd))
    return out


def stop_child_processes() -> None:
    """Leave no process running: the bench's spawn pools start
    multiprocessing's resource tracker, which lives until this interpreter
    exits and a moment after it; stop it and reap it here. Any other child
    still alive (a pool that was not shut down) is a fault: it is killed and
    the run fails."""
    import gc
    import signal
    from multiprocessing import resource_tracker

    # Finalise the pools' semaphores first: each unregisters with the
    # tracker, and would start a new one if it were already stopped.
    gc.collect()
    resource_tracker._resource_tracker._stop()
    left = _live_children()
    for pid, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    if left:
        raise AssertionError(f"processes left running, now killed: {left}")


def main() -> int:
    if sys.argv[1:2] == ["--dist-rank"]:
        _dist_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--cli-rank"]:
        return _cli_rank(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        return _run()
    finally:
        stop_child_processes()


def _run() -> int:
    from asltpu_torch.config import PreprocessConfig

    t0 = time.perf_counter()
    smi = phase_device()
    max_err, timing = phase_kernels()
    rgb = _lane("rgb", "mobilenet_gru", RGB_LANE, PreprocessConfig().staged_frame_shape)
    yuv = _lane("yuv420", "mobilenet_gru", YUV_LANE,
                PreprocessConfig(**YUV_LANE).staged_frame_shape)
    resnet = _lane("resnet", "resnet_transformer", RGB_LANE,
                   PreprocessConfig().staged_frame_shape)
    mbconv = phase_mbconv()
    fused = phase_fused_backbone()
    phase_host()
    phase_decode_backends()
    i3d = _lane("i3d", "i3d", RGB_LANE, PreprocessConfig().staged_frame_shape)
    fusion = _lane("two_stream", "two_stream", RGB_LANE,
                   PreprocessConfig().staged_frame_shape)
    train, pools_by_path = phase_train()
    tsf_rgb, short_by_path = phase_timesformer()
    train.update(tsf_rgb)
    short = phase_short_attention()
    windowed = phase_window_attention()
    pools_by_path["i3d/predict"] = [i3d["max_pool3d_same"], i3d["max_pool3d_same_backward"]]
    rgb_by_path = {"mobilenet_gru/rgb": rgb["preprocess_rgb"],
                   "resnet_transformer/rgb": resnet["preprocess_rgb"],
                   "i3d/rgb": i3d["preprocess_rgb"],
                   "two_stream/rgb": fusion["preprocess_rgb"], **train}
    if min(*rgb_by_path.values(), yuv["preprocess_yuv420"]) < 1:
        raise AssertionError(f"a kernel did not run on its lane: {rgb_by_path}, {yuv}")
    phase_stem()
    pool3d = phase_pool3d()
    phase_pose_lane()
    served, serve_timing, copy_share = phase_serve()
    rgb_by_path.update({p: served[p] for p in ("mobilenet_gru/serve", "two_stream/serve")})
    yuv_by_path = {"mobilenet_gru/yuv420": yuv["preprocess_yuv420"],
                   "mobilenet_gru/serve_yuv420": served["mobilenet_gru/serve_yuv420"]}
    if min(*served.values()) < 1:
        raise AssertionError(f"a kernel did not run on a serve path: {served}")
    exported, exported_pools = phase_export()
    pools_by_path.update(exported_pools)
    yuv_by_path["export/mobilenet_gru/yuv420"] = exported.pop("export/mobilenet_gru/yuv420")
    rgb_by_path.update(exported)
    rgb_by_path["cli/train"] = phase_learn()
    bench_launches = phase_bench()
    rgb_by_path["bench/realistic_rgb"] = bench_launches["bench/realistic_rgb"]
    yuv_by_path["bench/realistic_yuv420"] = bench_launches["bench/realistic_yuv420"]
    dist_launches, dist_timing = phase_dist()
    rgb_by_path.update(dist_launches)

    kernels = []
    for lane, fn, by_path, replaces in (
        ("rgb", "preprocess_rgb", rgb_by_path, "asltpu/ops/preprocess_pallas.py:67"),
        ("yuv420", "preprocess_yuv420", yuv_by_path, "asltpu/ops/preprocess_pallas.py:216"),
    ):
        t = timing[lane]
        kernels.append({
            "name": fn, "route": "cuda", "source": "asltpu_torch/csrc/preprocess.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[lane], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "share_of_bound": t["share_of_bound"], "copy_ms_info": t["copy_ms_info"],
        })
    kernels.append({
        "name": "fused_mbconv_s1", "route": "cuda", "source": "asltpu_torch/csrc/mbconv.cu",
        "replaces": "asltpu/ops/mbconv_pallas.py:105",
        "launches": fused["fused_mbconv_s1"], "max_abs_err": mbconv["max_abs_err"],
        "ms": mbconv["ms"], "plain_ms": mbconv["plain_ms"],
        "bound_ms": mbconv["bound_ms"], "bound_by": mbconv["bound_by"],
        "library_ms": None,
        "share_of_bound": mbconv["bound_ms"] / mbconv["ms"],
        "per": "sums over the 12 launches of one backbone call at 512 frames "
               "(per shape: phase kernels_mbconv)",
    })
    kernels.append({
        "name": "max_pool3d_same", "route": "cuda", "source": "asltpu_torch/csrc/pool3d.cu",
        "replaces": None,
        # [forward, backward]: phase train's train() at TRAIN_BATCH, remat on.
        "launches_per_step": [n // I3D_TRAIN_STEPS for n in pools_by_path["i3d/train"]],
        "launches_by_path": pools_by_path,
        "max_grad_ulps": pool3d["max_grad_ulps"],
        "ms": pool3d["ms_fwd"] + pool3d["ms_bwd"],
        "bound_ms": pool3d["bound_ms_fwd"] + pool3d["bound_ms_bwd"], "bound_by": "bytes",
        "library_ms": pool3d["library_ms_fwd"] + pool3d["library_ms_bwd"],
        "share_of_bound": pool3d["share_of_bound"],
        "per": "sums forward and backward over I3D's 13 pools at batch 48 "
               "(per pool: phase pool3d)",
    })
    kernels.append({
        "name": "short_attention", "route": "cuda",
        "source": "asltpu_torch/csrc/short_attention.cu", "replaces": None,
        # [forward, backward] launches: phase timesformer's predict and two
        # train steps.
        "launches_by_path": short_by_path,
        "max_err_rel_to_max": short["max_err_rel_to_max"],
        "ms": short["ms_fwd"] + short["ms_bwd"],
        "plain_ms": short["plain_ms_fwd"] + short["plain_ms_bwd"],
        "bound_ms": short["bound_ms_fwd"] + short["bound_ms_bwd"], "bound_by": "bytes",
        "library_ms": short["library_ms_fwd"] + short["library_ms_bwd"],
        "share_of_bound": short["share_of_bound"],
        "per": "one TimeSformer-HR temporal layer at batch 8, forward and backward "
               "(phase short_attention)",
    })
    for layer, row in windowed.items():
        kernels.append({
            "name": f"window_attention/{layer}", "route": "cuda",
            "source": "asltpu_torch/csrc/window_attention.cu", "replaces": None,
            "max_err_rel_to_max": row["max_err_rel_to_max"],
            "ms": row["ms_fwd"] + row["ms_bwd"],
            "plain_ms": row["plain_ms_fwd"] + row["plain_ms_bwd"],
            "bound_ms": row["bound_ms_fwd"] + row["bound_ms_bwd"], "bound_by": "operations",
            "library_ms": row["library_ms_fwd"] + row["library_ms_bwd"],
            "share_of_bound": row["share_of_bound"],
            "per": f"one shifted Video Swin-B {layer} layer at batch 8 ({row['windows']} "
                   f"windows x {row['heads']} heads), forward and backward "
                   "(phase window_attention)",
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    # The serving timings (phase serve), each on a line of its own.
    for clients, prefix in ((1, "serve_c1_"), (4, "serve_c4_"), (32, "serve_")):
        print(f"serve concurrency {clients} (buckets {serve_timing['batch_buckets']}): "
              f"p50 {serve_timing[prefix + 'p50_ms']} ms, p99 {serve_timing[prefix + 'p99_ms']}"
              f" ms, {serve_timing[prefix + 'clips_per_sec']} clips/s, avg batch "
              f"{serve_timing[prefix + 'avg_batch']}", flush=True)
    print("serve host-to-device copy share of a batch: " + ", ".join(
        f"bucket {b} {v['copy_share']} ({v['copy_ms']} of {v['batch_ms']} ms)"
        for b, v in copy_share.items()), flush=True)
    # Phase dist's step times (host clock; information, not a claim: two
    # gloo ranks share one card and stage every collective through the host).
    for key, ms in dist_timing.items():
        print(f"dist {key} (host clock, each step): {ms}", flush=True)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
