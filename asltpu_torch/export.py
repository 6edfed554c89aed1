"""Deployment export: a model's whole inference program (staged uint8
frames and/or landmarks → logits, preprocess included) as a
``torch.export`` program, beside the config needed to stage its inputs.
Counterpart of ``asltpu/export.py``. The artifact is a directory:

    program.pt2   ``torch.export.save`` of the ``ExportedProgram`` (weights
                  included)
    meta.json     family, config, input signature, batch size, the platform
                  it was traced on, the preprocess lane it traced, format
                  and torch versions

Loading (:func:`load_exported`) needs no model code: it imports the custom
op registrations (:mod:`asltpu_torch.ops.preprocess_kernels`,
:mod:`asltpu_torch.ops.pool3d_kernels`: I3D's programs call
``asltpu_torch::max_pool3d_same`` on either platform) and the config, never
``asltpu_torch.models``.

The preprocess dispatcher (:func:`asltpu_torch.ops.preprocess.preprocess_clip`)
chooses its lane from the device of the frames at trace time, so an export
targets the platform it was traced on (``platforms`` in meta.json). Traced
on the card, the program calls the custom op ``asltpu_torch::preprocess_rgb``
(or ``::preprocess_yuv420``), and so launches the hand-written CUDA kernel
when it runs, as a TPU export of the JAX package carries its Pallas kernel;
traced on the CPU it holds the plain preprocess as PyTorch ops. ``.pt2``
files are not promised to load under another torch version than the one
that wrote them (``torch_version`` in meta.json), so export where you serve.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from asltpu_torch.config import PoseBiLSTMConfig, TwoStreamFusionConfig, get_config
from asltpu_torch.data.pad import pad_to_batch
from asltpu_torch.data.wlasl import gloss_label
from asltpu_torch.ops import pool3d_kernels, preprocess_kernels  # noqa: F401  (the custom ops)
from asltpu_torch.ops.preprocess import preprocess_clip

FORMAT_VERSION = 1

_PROGRAM = "program.pt2"
_META = "meta.json"
# The preprocess kernels' custom ops in a traced graph.
_OP_PREFIX = "asltpu_torch.preprocess_"


def _cfg_to_jsonable(cfg) -> Dict[str, Any]:
    """Frozen-dataclass config → JSON-safe dict (tuples become lists;
    :func:`_cfg_from_jsonable` restores them)."""
    return dataclasses.asdict(cfg)


def _tuplify(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _cfg_from_jsonable(family: str, cfg_dict: Dict[str, Any]):
    """Rebuild the frozen config through :func:`get_config`, the path user
    code takes, so its checks run again."""
    fields = _tuplify(dict(cfg_dict))
    # ``name`` repeats the registry key, which get_config takes positionally.
    fields.pop("name", None)
    pp = fields.pop("preprocess", None)
    if pp is not None:
        fields["preprocess"] = _tuplify(pp)
    return get_config(family, **fields)


def _input_specs(cfg, batch_size: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of each program input, in the order of
    :meth:`asltpu_torch.api.Model.predict_fn`'s arguments."""
    specs: List[Tuple[str, Tuple[int, ...], str]] = []
    pp = getattr(cfg, "preprocess", None)
    if not isinstance(cfg, PoseBiLSTMConfig):
        specs.append(("frames", (batch_size, pp.num_frames, *pp.staged_frame_shape), "uint8"))
    if isinstance(cfg, (PoseBiLSTMConfig, TwoStreamFusionConfig)):
        t = pp.num_frames if pp is not None else cfg.num_frames
        specs.append(("landmarks", (batch_size, t, cfg.num_landmarks, cfg.landmark_dim),
                      "float32"))
    return specs


class _Program(nn.Module):
    """What ``Model.predict_fn`` computes, as a module to export: the
    preprocess (when the model takes frames), then the model."""

    def __init__(self, module: nn.Module, pp):
        super().__init__()
        self.module = module
        self.pp = pp

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.pp is None:
            return self.module(*inputs)
        frames, *rest = inputs
        return self.module(preprocess_clip(frames, self.pp), *rest)


def preprocess_ops(program: torch.export.ExportedProgram) -> List[str]:
    """The preprocess kernels' custom ops that ``program`` calls, e.g.
    ``["asltpu_torch::preprocess_rgb"]``."""
    names = {str(n.target) for n in program.graph.nodes
             if n.op == "call_function" and str(n.target).startswith(_OP_PREFIX)}
    return sorted("asltpu_torch::" + name.split(".")[1] for name in names)


def export_model(model, path: str, batch_size: int = 8) -> Dict[str, Any]:
    """Write ``model``'s inference program and config to the directory
    ``path``.

    The program is ``model.predict_fn()``'s function at a fixed
    ``batch_size`` (callers pad short batches with
    :func:`asltpu_torch.data.pad.pad_to_batch`, as the server does), traced
    by ``torch.export`` (non-strict) on ``model.device``. Returns the meta
    dict that was written.
    """
    specs = _input_specs(model.cfg, batch_size)
    args = tuple(torch.zeros(shape, dtype=getattr(torch, dt), device=model.device)
                 for _, shape, dt in specs)
    program = _Program(model.module, getattr(model.cfg, "preprocess", None))
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    ops = preprocess_ops(exported)
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _PROGRAM))
    meta = {
        "format_version": FORMAT_VERSION,
        "family": model.cfg.name,
        "config": _cfg_to_jsonable(model.cfg),
        "batch_size": batch_size,
        "platforms": [model.device.type],
        # The kernel op the program calls, "plain" for the plain PyTorch
        # preprocess, None for a model that takes no frames.
        "preprocess": (ops[0] if ops else "plain") if program.pp is not None else None,
        "inputs": [{"name": n, "shape": list(s), "dtype": d} for n, s, d in specs],
        "num_classes": model.cfg.num_classes,
        "torch_version": torch.__version__,
    }
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    # meta.json last and atomically: a directory with it is a whole artifact.
    os.replace(tmp, os.path.join(path, _META))
    return meta


@dataclasses.dataclass
class ExportedModel:
    """A loaded deployment artifact: inference with no model code.

    ``predict_batch`` runs the program at its fixed batch size; ``predict``
    takes one clip (pads, runs, takes the first row, as the server does).
    """

    meta: Dict[str, Any]
    cfg: Any
    program: torch.export.ExportedProgram
    device: torch.device
    _fn: Any = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self._fn = self.program.module()

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def takes_rgb(self) -> bool:
        return any(i["name"] == "frames" for i in self.meta["inputs"])

    @property
    def takes_landmarks(self) -> bool:
        return any(i["name"] == "landmarks" for i in self.meta["inputs"])

    @property
    def preprocess(self):
        return getattr(self.cfg, "preprocess", None)

    def _check(self, name: str, arr, batch: bool) -> np.ndarray:
        spec = next(i for i in self.meta["inputs"] if i["name"] == name)
        want = tuple(spec["shape"]) if batch else tuple(spec["shape"][1:])
        got = tuple(np.shape(arr))
        if got != want:
            raise ValueError(
                f"{name} shape {got} != exported {'batch ' if batch else ''}spec {want}"
            )
        return np.asarray(arr, dtype=spec["dtype"])

    def predict_batch(self, frames=None, landmarks=None) -> np.ndarray:
        """A full batch of the fixed size in → logits [B, num_classes]."""
        args = []
        if self.takes_rgb:
            args.append(self._check("frames", frames, batch=True))
        if self.takes_landmarks:
            args.append(self._check("landmarks", landmarks, batch=True))
        xs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in args]
        with torch.inference_mode():
            return self._fn(*xs).cpu().numpy()

    def predict(self, frames=None, landmarks=None,
                gloss_names=None) -> Tuple[Any, np.ndarray]:
        """One staged clip (no batch axis) → (gloss, logits [num_classes])."""
        kw = {}
        if self.takes_rgb:
            arr = self._check("frames", frames, batch=False)
            kw["frames"] = pad_to_batch(arr[None], self.batch_size)
        if self.takes_landmarks:
            arr = self._check("landmarks", landmarks, batch=False)
            kw["landmarks"] = pad_to_batch(arr[None], self.batch_size)
        logits = self.predict_batch(**kw)[0]
        return gloss_label(int(logits.argmax()), gloss_names), logits


def load_exported(path: str) -> ExportedModel:
    """Load an :func:`export_model` artifact directory. A directory without
    ``meta.json``, a ``format_version`` this package does not read, and a
    card artifact where there is no card are refused."""
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        raise IOError(f"not an export artifact (no {_META}): {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise IOError(
            f"unsupported artifact format_version={meta.get('format_version')} "
            f"(this asltpu_torch reads {FORMAT_VERSION})"
        )
    device = torch.device(meta["platforms"][0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the artifact {path} was exported on a CUDA device and no CUDA device "
            "is available here; export it again on the CPU to run it there"
        )
    program = torch.export.load(os.path.join(path, _PROGRAM))
    cfg = _cfg_from_jsonable(meta["family"], meta["config"])
    return ExportedModel(meta=meta, cfg=cfg, program=program, device=device)

