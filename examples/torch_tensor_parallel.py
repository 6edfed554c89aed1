"""Tensor parallelism with the PyTorch/CUDA port (``asltpu_torch.dist.tp``).

The transformer head's attention and MLP weights shard Megatron-style:
each rank holds its heads' q/k/v rows and ``out_proj`` columns, ``mlp1``'s
output rows and ``mlp2``'s input columns, and one all-reduce after each
half joins the ranks. The same placements apply to training: the AdamW
moments are as sharded as their parameters, and the TP train step walks
the replicated trajectory (tests/test_torch_tp.py). From the CLI:
``python -m torch.distributed.run --nproc-per-node 2 -m asltpu_torch.cli
train --model resnet_transformer --model-parallel 2``. Counterpart of
tensor_parallel.py.

    python examples/torch_tensor_parallel.py

This script starts its own two ranks over gloo, both on the one CUDA card,
or on the CPU with ASLTPU_EXAMPLE_FORCE_CPU=1.
"""

import os
import sys

# Runnable straight from a source checkout (no install needed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import socket
import subprocess
import tempfile

import numpy as np
import torch

RANKS = 2


def rank_main(out: str) -> None:
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.dist import (init_distributed, make_mesh, tp_shard_module,
                                   validate_tp_divisibility)
    from asltpu_torch.models.common import init_weights
    from asltpu_torch.models.temporal import TransformerHead
    from asltpu_torch.train.loop import create_train_state, make_train_step

    device = "cpu" if os.environ.get("ASLTPU_EXAMPLE_FORCE_CPU") else "cuda"
    init_distributed(backend="gloo")

    def head():
        h = TransformerHead(num_classes=16, feature_dim=64, num_frames=5, d_model=64,
                            num_heads=4, num_layers=2, mlp_ratio=4, dropout=0.0,
                            dtype=torch.float32)
        init_weights(h, torch.Generator().manual_seed(0))
        return h.to(device)

    validate_tp_divisibility(num_heads=4, d_model=64, mlp_ratio=4, model_parallel=RANKS)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 5, 64)).astype(np.float32)).to(device)
    with torch.no_grad():
        want = head()(feats)  # replicated reference

    # (data=1, model=2) mesh: the attention heads and the MLP's hidden width
    # shard over ``model``.
    mesh = make_mesh(model_parallel=RANKS)
    sharded = tp_shard_module(head(), mesh)
    with torch.no_grad():
        got = sharded(feats)

    # TP training: the optimizer is built on the sliced parameters, so its
    # moments are sliced too; gradients of the shards stay shards.
    cfg = TrainConfig(batch_size=8, num_steps=2, warmup_steps=0)
    state = create_train_state(sharded, cfg, mesh=mesh)
    labels = torch.arange(8, device=device) % 16
    state, metrics = make_train_step(cfg, mesh=mesh)(state, feats, labels)
    if mesh.model_rank == 0:
        with open(out, "w") as f:
            json.dump({"mesh": mesh.shape,
                       "mlp1": list(sharded.layers[0].mlp1.weight.shape),
                       "equal": bool(torch.allclose(got, want, atol=2e-5)),
                       "loss": float(metrics["loss"]), "step": state.step}, f)
    torch.distributed.destroy_process_group()


def main() -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="asltpu_torch_tp_"), "result.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-out", out],
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                 WORLD_SIZE=str(RANKS)))
        for r in range(RANKS)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"a rank failed: exit codes {codes}")
    with open(out) as f:
        r = json.load(f)
    print(f"mesh: {r['mesh']}")
    print(f"mlp1 weight on each rank: {tuple(r['mlp1'])} of (256, 64)")
    print(f"TP logits equal replicated: {r['equal']}")
    print(f"TP train step: loss {r['loss']:.4f}, step {r['step']}")


if __name__ == "__main__":
    if "--rank-out" in sys.argv:
        rank_main(sys.argv[sys.argv.index("--rank-out") + 1])
    else:
        main()
