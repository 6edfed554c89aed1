"""Bring-up in the port (``asltpu_torch.dist.multihost``), as
``tests/unit/test_multihost.py`` holds the JAX package's: the
single-process no-op, a real two-process ``init_distributed`` (by an
explicit address, then by ``torchrun``'s environment variables) with each
rank's share of a global batch, and a bring-up to an address nobody
serves, which must raise within its timeout instead of hanging. The two
ranks are launched once for the file (``torch_dist_ranks.launch``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as R
from asltpu_torch.dist import (assemble_global_batch, init_distributed, local_batch_size,
                               make_mesh)


# Rank 1 of a world whose rank 0 never listens (a process of its own: a
# failed bring-up leaves its process unable to join another world).
_DEAD = """
import sys, time
sys.path.insert(0, {repo!r})
from asltpu_torch.dist import init_distributed
t = time.monotonic()
try:
    init_distributed("127.0.0.1:{port}", 2, 1, backend="gloo", timeout_s={timeout})
except Exception as e:
    print("raised", type(e).__name__, time.monotonic() - t)
else:
    print("joined")
"""
DEAD_TIMEOUT_S = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two-rank launch, with the dead-address bring-up running beside
    it: (out dir, the launch's failure or None, the dead bring-up's
    output)."""
    out = str(tmp_path_factory.mktemp("multihost"))
    dead = subprocess.Popen([sys.executable, "-c", _DEAD.format(
        repo=R.REPO, port=R.free_port(), timeout=DEAD_TIMEOUT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        failure = R.launch("multihost", 2, out)
        dead_out = dead.communicate(timeout=60)
    finally:
        if dead.poll() is None:
            dead.kill()
            dead.wait()
    return out, failure, dead_out


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 0
    assert not dist.is_initialized()


def test_local_batch_size_single_process():
    assert local_batch_size(32) == 32


def test_assemble_global_batch_single_process_places_the_rows():
    batch = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3), np.arange(8))
    frames, labels = assemble_global_batch(make_mesh(), batch, device="cpu")
    assert isinstance(frames, torch.Tensor) and frames.device.type == "cpu"
    np.testing.assert_array_equal(frames.numpy(), batch[0])
    np.testing.assert_array_equal(labels.numpy(), batch[1])


@pytest.mark.parametrize("rank", [0, 1])
def test_two_process_bringup(ranks, rank):
    """Both ranks join by ``host:port`` (a second call returns the rank),
    hold 4 of 8 rows each, gather them back (sum of all 8 rows), refuse a
    batch of 7, and join again by ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``."""
    out, failure, _ = ranks
    assert failure is None, failure
    got = R.load(out, "bringup", rank)
    assert got["tcp"] == (rank, 2, "gloo")
    assert got["again"] == rank
    assert got["local_batch"] == 4
    assert got["odd_batch"] == "global batch 7 not divisible by process count 2"
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) * 10.0
    np.testing.assert_array_equal(got["rows"].numpy(), x[4 * rank:4 * rank + 4])
    assert got["sum"] == float(x.sum())
    assert got["all_reduce"] == 3.0
    assert got["env"] == (rank, 2, 3.0)


def test_bringup_to_a_dead_address_raises_within_its_timeout(ranks):
    """Rank 1 of a world whose rank 0 never listens: the rendezvous gives
    up after ``timeout_s`` (2 s) and raises."""
    stdout, stderr = ranks[2]
    words = stdout.split()
    assert words and words[0] == "raised", (stdout, stderr[-2000:])
    assert float(words[-1]) < 10 * DEAD_TIMEOUT_S
