"""Data-parallel batched inference with the PyTorch/CUDA port.

Each rank is a process of its own (``torch.distributed``): it takes its
rows of the global batch (``asltpu_torch.dist.shard_batch``), runs the
model on them, and the logits are gathered back in rank order
(``gather_batch``). Counterpart of sharded_inference.py.

    python examples/torch_sharded_inference.py

This script starts its own two ranks over gloo, both on the one CUDA card
(NCCL puts no two ranks of a group on one device), or on the CPU with
ASLTPU_EXAMPLE_FORCE_CPU=1. Launched under
``python -m torch.distributed.run --nproc-per-node N`` it joins that world
instead (one rank per card there, with NCCL).
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
GLOBAL_BATCH = 16


def rank_main(out: str) -> None:
    from asltpu_torch.api import load_model
    from asltpu_torch.dist import gather_batch, init_distributed, make_mesh, shard_batch

    device = "cpu" if os.environ.get("ASLTPU_EXAMPLE_FORCE_CPU") else None  # None: the card
    init_distributed(backend=os.environ.get("ASLTPU_EXAMPLE_BACKEND"))
    model = load_model(
        "mobilenet_gru", device=device, gru_hidden=16, width_mult=0.35,
        preprocess={"num_frames": 4, "staging_size": (48, 48), "resize_short": 40,
                    "crop": 32},
    )
    mesh = make_mesh()  # (data, model=1); see torch_tensor_parallel.py for TP
    pp = model.cfg.preprocess
    # Every rank makes the same global batch (a real job reads only its rows).
    frames = np.random.default_rng(0).integers(
        0, 256, (GLOBAL_BATCH, pp.num_frames, *pp.staged_frame_shape), np.uint8)
    fn = model.predict_fn()
    with torch.no_grad():
        local = fn(torch.from_numpy(shard_batch(mesh, frames)).to(model.device))
        logits = gather_batch(mesh, local)
        whole = fn(torch.from_numpy(frames).to(model.device))
    if mesh.data_rank == 0:
        with open(out, "w") as f:
            json.dump({"ranks": mesh.data_size, "local": list(local.shape),
                       "logits": list(logits.shape),
                       "equal": bool(torch.allclose(logits.float(), whole.float(),
                                                    atol=1e-2))}, f)
    torch.distributed.destroy_process_group()


def main() -> None:
    if "RANK" in os.environ:  # launched by torchrun: this process is a rank
        return rank_main(os.path.join(tempfile.gettempdir(), "asltpu_sharded_example.json"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="asltpu_torch_sharded_"), "result.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-out", out],
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                 WORLD_SIZE=str(RANKS), LOCAL_RANK=str(r), ASLTPU_EXAMPLE_BACKEND="gloo"))
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
    print(f"mesh: {r['ranks']} ranks, axes ('data', 'model')")
    print(f"logits {tuple(r['logits'])} gathered from {r['ranks']} ranks; "
          f"per-rank batch {r['local'][0]}")
    print(f"sharded logits equal one process's: {r['equal']}")


if __name__ == "__main__":
    if "--rank-out" in sys.argv:
        rank_main(sys.argv[sys.argv.index("--rank-out") + 1])
    else:
        main()
