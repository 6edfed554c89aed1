"""Weights and train states in and out of the port: from the JAX package's
variables, from torchvision-layout ``.pt``/``.pth`` files, and the port's
own training checkpoints. Counterpart of ``asltpu/ckpt.py``: its torch
import half (``import_mobilenetv2``, ``import_resnet18``,
``import_torch_rnn``, ``import_transformer_head``,
``load_torch_checkpoint``) run in the other direction, and its train-state
half (``save_train_state``, ``try_restore_train_state``,
``save_best_state``, ``load_best_metric``, ``save_data_state``,
``load_data_state``) in the port's own layout.

Layout rules (flax → torch):

  - conv kernel  (kH, kW, I, O)  → weight (O, I, kH, kW); 3D (kD, kH,
    kW, I, O) → (O, I, kD, kH, kW)
  - depthwise    (kH, kW, 1, C)  → weight (C, 1, kH, kW) (same permutation)
  - BatchNorm scale/bias → weight/bias; batch_stats mean/var →
    running_mean/running_var
  - GRU ``l{k}_wi [F, 3H]`` / ``l{k}_wh [H, 3H]`` → ``weight_ih_l{k}`` /
    ``weight_hh_l{k}`` transposed; ``l{k}_bi``/``l{k}_bh`` →
    ``bias_ih_l{k}``/``bias_hh_l{k}``
  - bidirectional LSTM ``l{k}_{fwd,bwd}_{wi,wh}`` → ``weight_{ih,hh}_l{k}``
    (``_reverse`` for bwd) transposed; the one bias ``b`` → ``bias_ih = b``
    and ``bias_hh = 0`` (``asltpu.ckpt.import_torch_rnn`` sums them back)
  - Dense kernel (I, O) → Linear weight (O, I)
  - attention ``query``/``key``/``value`` kernels [d, heads, hd] → the
    q;k;v row blocks of ``in_proj_weight`` [3d, d] (biases [heads, hd] →
    ``in_proj_bias``); ``out`` [heads, hd, d] → ``out_proj.weight`` [d, d]
  - LayerNorm scale/bias → weight/bias
  - I3D: each ``Unit3D``'s ``unit/{conv,bn}`` → pytorch-i3d's
    ``{name}.conv3d``/``{name}.bn`` (the stem's kernel sits at
    ``Conv3d_1a_7x7/unit/conv/kernel`` as in every other unit); the
    ``logits`` Dense (1024, C) → ``logits.conv3d.weight`` (C, 1024, 1, 1, 1)
  - two-stream: ``rgb_backbone`` → ``features.*``; ``fusion{i}`` →
    ``fusion.{i}.*``, attention as above

Training checkpoints, under the JAX package's directory names::

    ckpt_dir/<step>/train_state.pt      step, model state_dict (fp32 params
                                        and BN buffers), optimizer and
                                        schedule state_dicts, generator state
    ckpt_dir/<step>/data_state.bin      the data stream's position (bytes)
    ckpt_dir/best/<step>/train_state.pt the state with the best eval metric
    ckpt_dir/best/best_metric.json      {"metric", "metric_name", "step"}

Each step dir is written under a temporary name and renamed into place,
so a cut run leaves no half step dir; ``torch.load`` reads them with
``weights_only=True``. The JAX package's orbax directories are not read:
``orbax.checkpoint`` imports ``jax``, and the port imports none.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from asltpu_torch.config import (
    I3DConfig,
    MobileNetV2GRUConfig,
    ModelConfig,
    PoseBiLSTMConfig,
    ResNet18TransformerConfig,
    TwoStreamFusionConfig,
)

Variables = Mapping[str, Any]


def _conv(w: np.ndarray) -> torch.Tensor:
    """flax (*spatial, I, O) → torch (O, I, *spatial)."""
    w = np.asarray(w)
    return torch.from_numpy(np.ascontiguousarray(
        w.transpose(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))))


def _vec(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def convbn_state_dict(params: Mapping, stats: Mapping, conv_key: str = "0",
                      bn_key: str = "1") -> Dict[str, torch.Tensor]:
    """JAX ``ConvBN`` params/batch_stats → the conv's and BN's entries."""
    return {
        f"{conv_key}.weight": _conv(params["conv"]["kernel"]),
        f"{bn_key}.weight": _vec(params["bn"]["scale"]),
        f"{bn_key}.bias": _vec(params["bn"]["bias"]),
        f"{bn_key}.running_mean": _vec(stats["bn"]["mean"]),
        f"{bn_key}.running_var": _vec(stats["bn"]["var"]),
        f"{bn_key}.num_batches_tracked": torch.tensor(0),
    }


def inverted_residual_state_dict(params: Mapping, stats: Mapping,
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``InvertedResidual`` → torchvision's ``conv.*`` of one block:
    [expand ConvBN,] depthwise ConvBN, project conv, project BN."""
    c = f"{prefix}conv"
    sd: Dict[str, torch.Tensor] = {}
    j = 0
    if "expand" in params:
        sd.update(convbn_state_dict(
            params["expand"], stats["expand"], f"{c}.0.0", f"{c}.0.1"))
        j = 1
    sd.update(convbn_state_dict(
        params["depthwise"], stats["depthwise"], f"{c}.{j}.0", f"{c}.{j}.1"))
    sd.update(convbn_state_dict(
        params["project"], stats["project"], f"{c}.{j + 1}", f"{c}.{j + 2}"))
    return sd


def mobilenetv2_state_dict(params: Mapping, stats: Mapping,
                           prefix: str = "features.") -> Dict[str, torch.Tensor]:
    """JAX ``MobileNetV2`` params/batch_stats → torchvision ``features.*``
    (the inverse of ``asltpu.ckpt.import_mobilenetv2``)."""
    sd = convbn_state_dict(
        params["stem"], stats["stem"], f"{prefix}0.0", f"{prefix}0.1")
    n_blocks = sum(1 for k in params if k.startswith("block"))
    for i in range(1, n_blocks + 1):
        sd.update(inverted_residual_state_dict(
            params[f"block{i - 1}"], stats[f"block{i - 1}"], f"{prefix}{i}."))
    head = n_blocks + 1
    sd.update(convbn_state_dict(
        params["head"], stats["head"], f"{prefix}{head}.0", f"{prefix}{head}.1"))
    return sd


def basic_block_state_dict(params: Mapping, stats: Mapping,
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``BasicBlock`` → torchvision's names of one block: ``conv1``/
    ``bn1``, ``conv2``/``bn2`` and, where the block has one,
    ``downsample.0``/``.1``."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2"):
        sd.update(convbn_state_dict(params[name], stats[name], f"{prefix}{name}",
                                    f"{prefix}bn{name[-1]}"))
    if "downsample" in params:
        sd.update(convbn_state_dict(params["downsample"], stats["downsample"],
                                    f"{prefix}downsample.0", f"{prefix}downsample.1"))
    return sd


def resnet18_state_dict(params: Mapping, stats: Mapping,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``ResNet18`` params/batch_stats → torchvision ``resnet18`` names
    (the inverse of ``asltpu.ckpt.import_resnet18``)."""
    sd = convbn_state_dict(params["stem"], stats["stem"], f"{prefix}conv1",
                           f"{prefix}bn1")
    for stage in range(1, 5):
        for blk in range(2):
            f = f"layer{stage}_{blk}"
            sd.update(basic_block_state_dict(params[f], stats[f],
                                             f"{prefix}layer{stage}.{blk}."))
    return sd


def _linear(params: Mapping, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _vec(np.asarray(params["kernel"]).T),
            f"{name}.bias": _vec(params["bias"])}


def _layer_norm(params: Mapping, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _vec(params["scale"]), f"{name}.bias": _vec(params["bias"])}


def _mha(params: Mapping, name: str) -> Dict[str, torch.Tensor]:
    """flax ``MultiHeadDotProductAttention`` → ``nn.MultiheadAttention``
    (the inverse of ``asltpu.ckpt._import_mha``)."""
    d = np.asarray(params["out"]["kernel"]).shape[-1]
    qkv = ("query", "key", "value")
    return {
        f"{name}.in_proj_weight": _vec(np.concatenate(
            [np.asarray(params[n]["kernel"]).reshape(d, d).T for n in qkv])),
        f"{name}.in_proj_bias": _vec(np.concatenate(
            [np.asarray(params[n]["bias"]).reshape(d) for n in qkv])),
        f"{name}.out_proj.weight": _vec(np.asarray(params["out"]["kernel"]).reshape(d, d).T),
        f"{name}.out_proj.bias": _vec(params["out"]["bias"]),
    }


def transformer_head_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerHead`` params → the port's names (``cls``, ``pos``,
    [``in_proj``,] ``layers.{i}.{ln1, attn, ln2, mlp1, mlp2}``,
    ``final_ln``, ``fc``): the inverse of
    ``asltpu.ckpt.import_transformer_head``."""
    sd = {"cls": _vec(params["cls"]), "pos": _vec(params["pos"])}
    if "in_proj" in params:
        sd.update(_linear(params["in_proj"], "in_proj"))
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        p, t = params[f"layer{i}"], f"layers.{i}"
        sd.update(_mha(p["attn"], f"{t}.attn"))
        for name in ("ln1", "ln2"):
            sd.update(_layer_norm(p[name], f"{t}.{name}"))
        for name in ("mlp1", "mlp2"):
            sd.update(_linear(p[name], f"{t}.{name}"))
    sd.update(_layer_norm(params["final_ln"], "final_ln"))
    sd.update(_linear(params["fc"], "fc"))
    return sd


def gru_head_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """JAX ``GRUHead`` params → ``gru.*`` (``torch.nn.GRU`` names) + ``fc.*``."""
    sd: Dict[str, torch.Tensor] = {}
    for k in range(num_layers):
        sd[f"gru.weight_ih_l{k}"] = _vec(np.asarray(params[f"l{k}_wi"]).T)
        sd[f"gru.weight_hh_l{k}"] = _vec(np.asarray(params[f"l{k}_wh"]).T)
        sd[f"gru.bias_ih_l{k}"] = _vec(params[f"l{k}_bi"])
        sd[f"gru.bias_hh_l{k}"] = _vec(params[f"l{k}_bh"])
    sd.update(_linear(params["fc"], "fc"))
    return sd


def bilstm_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """JAX ``PoseBiLSTM`` params → ``lstm.*`` (``torch.nn.LSTM(
    bidirectional=True)`` names) + ``fc.*``."""
    sd: Dict[str, torch.Tensor] = {}
    for k in range(num_layers):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            p = f"l{k}_{direction}_"
            b = _vec(params[p + "b"])
            sd[f"lstm.weight_ih_l{k}{sfx}"] = _vec(np.asarray(params[p + "wi"]).T)
            sd[f"lstm.weight_hh_l{k}{sfx}"] = _vec(np.asarray(params[p + "wh"]).T)
            sd[f"lstm.bias_ih_l{k}{sfx}"] = b
            sd[f"lstm.bias_hh_l{k}{sfx}"] = torch.zeros_like(b)
    sd.update(_linear(params["fc"], "fc"))
    return sd


def i3d_state_dict(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``I3D`` params/batch_stats → pytorch-i3d names (the inverse of
    ``asltpu.ckpt.import_i3d``)."""
    sd: Dict[str, torch.Tensor] = {}

    def unit(p: Mapping, s: Mapping, name: str) -> None:
        sd.update(convbn_state_dict(p["unit"], s["unit"], f"{name}.conv3d", f"{name}.bn"))

    for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        unit(params[name], stats[name], name)
    for mixed in (k for k in params if k.startswith("Mixed_")):
        for branch in params[mixed]:
            unit(params[mixed][branch], stats[mixed][branch], f"{mixed}.{branch}")
    kernel = np.asarray(params["logits"]["kernel"])  # (1024, C)
    sd["logits.conv3d.weight"] = _vec(kernel.T.reshape(*kernel.T.shape, 1, 1, 1))
    sd["logits.conv3d.bias"] = _vec(params["logits"]["bias"])
    return sd


def cross_attention_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``CrossAttentionBlock`` params → ``{a_from_b,b_from_a}_{lnq,
    lnkv,attn}`` and ``{a,b}_mlp_{ln,fc1,fc2}``."""
    sd: Dict[str, torch.Tensor] = {}
    for way in ("a_from_b", "b_from_a"):
        for ln in ("lnq", "lnkv"):
            sd.update(_layer_norm(params[f"{way}_{ln}"], f"{prefix}{way}_{ln}"))
        sd.update(_mha(params[f"{way}_attn"], f"{prefix}{way}_attn"))
    for stream in ("a_mlp", "b_mlp"):
        sd.update(_layer_norm(params[f"{stream}_ln"], f"{prefix}{stream}_ln"))
        for fc in ("fc1", "fc2"):
            sd.update(_linear(params[f"{stream}_{fc}"], f"{prefix}{stream}_{fc}"))
    return sd


def two_stream_state_dict(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``TwoStreamFusion`` params/batch_stats → the names
    ``asltpu.ckpt.import_two_stream`` reads."""
    sd = mobilenetv2_state_dict(params["rgb_backbone"], stats["rgb_backbone"])
    sd["pos"] = _vec(params["pos"])
    for name in ("rgb_proj", "kp_proj", "fc"):
        sd.update(_linear(params[name], name))
    n_layers = sum(1 for k in params if k.startswith("fusion"))
    for i in range(n_layers):
        sd.update(cross_attention_state_dict(params[f"fusion{i}"], f"fusion.{i}."))
    return sd


def state_dict_from_jax(cfg: ModelConfig, variables: Variables) -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` from the JAX model's variables, given
    as a numpy tree (``jax.device_get(model.variables)``: ``params``, plus
    ``batch_stats`` where the model has BatchNorm)."""
    if isinstance(cfg, PoseBiLSTMConfig):
        return bilstm_state_dict(variables["params"], cfg.num_layers)
    if not isinstance(cfg, (MobileNetV2GRUConfig, ResNet18TransformerConfig, I3DConfig,
                            TwoStreamFusionConfig)):
        raise ValueError(f"no weight layout for config {type(cfg).__name__}")
    params, stats = variables["params"], variables["batch_stats"]
    if isinstance(cfg, I3DConfig):
        return i3d_state_dict(params, stats)
    if isinstance(cfg, TwoStreamFusionConfig):
        return two_stream_state_dict(params, stats)
    if isinstance(cfg, MobileNetV2GRUConfig):
        sd = mobilenetv2_state_dict(params["backbone"], stats["backbone"])
        sd.update(gru_head_state_dict(params["head"], cfg.gru_layers))
        return sd
    sd = resnet18_state_dict(params["backbone"], stats["backbone"])
    sd.update({f"head.{k}": t for k, t in
               transformer_head_state_dict(params["head"]).items()})
    return sd


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a state dict (bare, or wrapped as
    ``{"state_dict": ...}``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


# Groups of a model's keys that a checkpoint may leave out as a whole: the
# module keeps its own. As in the JAX importer: a backbone plus GRU file
# without ``fc.*`` keeps the classifier, a ResNet-18 file without
# ``head.*`` the transformer head, a pytorch-i3d file without ``logits.*``
# (a Kinetics backbone for a new class count) the I3D classifier.
_OPTIONAL_GROUPS = ("fc.", "head.", "logits.")


def load_torch_checkpoint(module: nn.Module, path: str) -> None:
    """Load a torchvision-layout ``.pt``/``.pth`` into ``module`` in place.
    A group of ``_OPTIONAL_GROUPS`` of which the file holds no key keeps
    the module's own weights; any other missing or unexpected key raises."""
    sd = load_state_dict(path)
    absent = tuple(g for g in _OPTIONAL_GROUPS if not any(k.startswith(g) for k in sd))
    result = module.load_state_dict(sd, strict=False)
    missing = [
        k for k in result.missing_keys
        if not (k.startswith(absent) or k.endswith("num_batches_tracked"))
    ]
    if missing or result.unexpected_keys:
        raise KeyError(
            f"checkpoint {path} does not fit {type(module).__name__}: "
            f"missing {missing}, unexpected {result.unexpected_keys}"
        )


# --------------------------------------------------------------------------
# training checkpoints
# --------------------------------------------------------------------------

STATE_FILE = "train_state.pt"
DATA_STATE_FILE = "data_state.bin"
_BEST_METRIC_FILE = "best_metric.json"


def _steps(directory: str) -> list:
    """The step numbers under ``directory``, newest first."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(d) for d in os.listdir(directory) if d.isdigit()), reverse=True)


def _state_tree(state) -> Dict[str, Any]:
    return {
        "step": int(state.step),
        "model": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "schedule": state.schedule.state_dict(),
        "generator": state.generator.get_state(),
    }


def _write_step_dir(directory: str, step: int, tree: Dict[str, Any],
                    data_state: Optional[bytes] = None) -> str:
    """``directory/<step>/`` holding ``tree`` (and ``data_state``), written
    under a temporary name and renamed into place; an existing step dir of
    the same number is replaced."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.partial")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    if data_state is not None:
        with open(os.path.join(tmp, DATA_STATE_FILE), "wb") as f:
            f.write(data_state)
    if os.path.isdir(path):
        old = os.path.join(directory, f".{step}.old")
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    return path


def save_train_state(directory: str, state, keep: int = 3,
                     data_state: Optional[bytes] = None) -> str:
    """Save a :class:`~asltpu_torch.train.loop.TrainState` (and, given, the
    data stream's position, in the same step dir) under
    ``directory/<step>``, pruning to the newest ``keep`` step dirs."""
    path = _write_step_dir(directory, int(state.step), _state_tree(state), data_state)
    if keep > 0:
        for old in _steps(directory)[keep:]:
            shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return path


def _state_file(path: str) -> str:
    """The train-state file of a step dir, or of the newest step dir under
    ``path`` (a ``ckpt_dir`` or its ``best/``)."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        steps = _steps(path)
        if steps:
            path = os.path.join(path, str(steps[0]))
    f = os.path.join(path, STATE_FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(
            f"no port training checkpoint ({STATE_FILE}) at {path}; the JAX package's "
            "orbax checkpoints are not read: orbax.checkpoint imports jax, and the port "
            "imports none")
    return f


def _load(path: str) -> Dict[str, Any]:
    return torch.load(_state_file(path), map_location="cpu", weights_only=True)


def try_restore_train_state(directory: str, state):
    """Resume ``state`` in place from the newest step under ``directory``
    if there is one (module, optimizer, schedule, generator and step); a
    fresh run's state is returned unchanged."""
    if not _steps(directory):
        return state
    tree = _load(directory)
    state.module.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.schedule.load_state_dict(tree["schedule"])
    state.generator.set_state(tree["generator"])
    state.step = tree["step"]
    return state


def load_trained_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (fp32) of a port training checkpoint: a step
    dir, a ``ckpt_dir`` (its newest step) or its ``best/``."""
    return _load(path)["model"]


def save_best_state(directory: str, state, metric: float,
                    metric_name: str = "eval_top1") -> bool:
    """Keep ``directory/best/`` as the train state with the highest
    ``metric`` so far, the metric recorded beside it. Only a strictly
    greater metric replaces it (a tie keeps the earlier one), compared with
    the record on disk, so a resumed run never replaces a better state
    saved before the restart. Returns whether this state became the best."""
    best_dir = os.path.join(directory, "best")
    prev = load_best_metric(directory)
    if prev is not None and prev["metric"] >= metric:
        return False
    step = int(state.step)
    _write_step_dir(best_dir, step, _state_tree(state))
    for other in _steps(best_dir):
        if other != step:
            shutil.rmtree(os.path.join(best_dir, str(other)), ignore_errors=True)
    # Write, then rename: a cut run leaves the old record or none.
    tmp = os.path.join(best_dir, _BEST_METRIC_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"metric": float(metric), "metric_name": metric_name, "step": step}, f)
    os.replace(tmp, os.path.join(best_dir, _BEST_METRIC_FILE))
    return True


def load_best_metric(directory: str) -> Optional[Dict[str, Any]]:
    """The ``{"metric", "metric_name", "step"}`` record of
    ``directory/best/``, or None where there is no readable one."""
    try:
        with open(os.path.join(directory, "best", _BEST_METRIC_FILE)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or not isinstance(rec.get("metric"), (int, float)):
        return None
    return rec


def save_data_state(directory: str, step: int, state_bytes: bytes) -> None:
    """Write the data stream's position into ``directory/<step>/`` (made if
    absent), under a temporary name and then renamed."""
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, DATA_STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        f.write(state_bytes)
    os.replace(tmp, os.path.join(step_dir, DATA_STATE_FILE))


def load_data_state(directory: str) -> Optional[bytes]:
    """The data stream's position saved with the newest step, if any (an
    older step's would not match the train state a resume restores)."""
    steps = _steps(directory)
    if not steps:
        return None
    p = os.path.join(directory, str(steps[0]), DATA_STATE_FILE)
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return f.read()
