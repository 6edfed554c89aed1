"""Softmax attention over short sequences, read from the packed q/k/v
projection: the wrapper of the hand-written CUDA kernels
(``asltpu_torch/csrc/short_attention.cu``), their plain PyTorch versions,
the custom ops and the launch counters.

The kernels replace no TPU kernel: the JAX package has no TimeSformer. They
serve TimeSformer's temporal attention, each patch position over its 16
frames: 6,272 sequences × 12 heads of 64 a layer at batch 8. On the card
PyTorch's fused attention backends (cuDNN's first) took about 14% of that
work's memory bound, and splitting the packed projection into q, k and v
views made each backward build three full-size zero tensors, copy a gradient
into each and add them.

- ``asltpu_torch::short_attention(qkv, heads) -> out``: ``qkv`` [N, L, 3·d]
  with columns q; k; v (what ``F.linear`` of a packed projection gives),
  each ``heads`` heads of d / heads; ``out`` [N, L, d], the heads side by
  side as the output projection reads them: ``softmax(q·kᵀ / √D)·v``. With
  ``register_autograd``; the backward saves only ``qkv``.
- ``asltpu_torch::short_attention_backward(grad_out, qkv, heads) ->
  grad_qkv``: the gradient of ``qkv`` in its own layout, written whole.

Both have fake implementations. For a CPU tensor each op runs its plain
version, in the order of operations of
:func:`asltpu_torch.ops.attention.plain_attention`: :func:`short_attention_plain`
and :func:`short_attention_backward_plain` (the softmax's gradient written
out, with δ = rowsum(P ∘ dP)). For a CUDA tensor it launches its kernel or
raises ``ValueError`` before any launch: bf16, heads of :data:`HEAD_SIZE`,
1 ≤ L ≤ :data:`MAX_LEN` (:func:`kernel_takes`, which this module alone
states), contiguous and 16-byte aligned; no fallback. Which sequences go
to the op is decided in :func:`asltpu_torch.ops.attention.attention`. Each
launch adds one to ``short_attention.launches`` or
``short_attention_backward.launches``; each call, from its checks to its
launch, runs inside the span ``attention.short``
(:func:`asltpu_torch.utils.profiling.span`).

Numerics on the card: bf16 in and out, fp32 products and softmax inside,
rounded as FlashAttention-2 rounds (P to bf16 for the weighted sum and for
dv, dS to bf16 for dq and dk); no mask, no dropout, scale 1/√64. Bound, on
the card: the bytes moved once, 11 bf16 values a token and model width for
both directions (forward qkv and out; backward qkv, grad_out and grad_qkv).
The source file says how the kernels go after it."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from asltpu_torch.ops import _build
from asltpu_torch.utils.profiling import span

# The span around each call of either direction.
SPAN = "attention.short"
# What the kernels take: heads of 64, up to 32 tokens a sequence.
HEAD_SIZE = 64
MAX_LEN = 32
_INT32 = 2**31


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("short_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_short_attention_fwd.argtypes = [p, p, i, i, i, i, p]
    lib.asl_short_attention_fwd.restype = i
    lib.asl_short_attention_bwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.asl_short_attention_bwd.restype = i
    return lib


def _geometry(qkv: torch.Tensor, heads: int) -> Tuple[int, int, int]:
    """(N, L, d) of a packed projection of ``heads`` heads; raises
    ``ValueError`` on any other shape."""
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"short_attention: expected qkv [N, L, 3·d] with d a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    n, length, width = qkv.shape
    return n, length, width // 3


def _heads(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """q, k, v of a packed projection as [N, H, L, D] views."""
    n, length, d = _geometry(qkv, heads)
    return qkv.view(n, length, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)


def short_attention_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention in plain PyTorch, in the inputs' dtype: (q·kᵀ)·(1/√D),
    softmax over the keys, times v, the heads laid side by side."""
    n, length, d = _geometry(qkv, heads)
    q, k, v = _heads(qkv, heads)
    scores = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    out = torch.matmul(scores.softmax(dim=-1), v)
    return out.transpose(1, 2).reshape(n, length, d)


def short_attention_backward_plain(grad_out: torch.Tensor, qkv: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """The gradient of ``qkv`` in plain PyTorch, P recomputed: dv = Pᵀ·dO,
    dP = dO·vᵀ, dS = P ∘ (dP − rowsum(P ∘ dP)) / √D, dq = dS·k, dk = dSᵀ·q,
    packed as q; k; v."""
    n, length, d = _geometry(qkv, heads)
    q, k, v = _heads(qkv, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = (torch.matmul(q, k.transpose(-2, -1)) * scale).softmax(dim=-1)
    do = grad_out.reshape(n, length, heads, d // heads).transpose(1, 2)
    dv = torch.matmul(p.transpose(-2, -1), do)
    dp = torch.matmul(do, v.transpose(-2, -1))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    dq, dk = torch.matmul(ds, k), torch.matmul(ds.transpose(-2, -1), q)
    return torch.stack((dq, dk, dv), dim=2).permute(0, 3, 2, 1, 4).reshape(n, length, 3 * d)


def _refusal(dtype: torch.dtype, head_dim: int, length: int) -> Optional[str]:
    """Why the kernels do not take sequences of ``length`` tokens in heads
    of ``head_dim`` in ``dtype``; None where they do."""
    if dtype != torch.bfloat16:
        return f"the kernels take bfloat16, got {dtype}"
    if head_dim != HEAD_SIZE:
        return f"the kernels take heads of {HEAD_SIZE}, got heads of {head_dim}"
    if not 1 <= length <= MAX_LEN:
        return f"the kernels take 1 to {MAX_LEN} tokens a sequence, got {length}"
    return None


def kernel_takes(dtype: torch.dtype, head_dim: int, length: int) -> bool:
    """Whether the kernels take sequences of ``length`` tokens in heads of
    ``head_dim`` in ``dtype``: bf16, heads of :data:`HEAD_SIZE`, 1 to
    :data:`MAX_LEN` tokens. A packed projection that ``F.linear`` wrote
    also meets the layout the launch checks."""
    return _refusal(dtype, head_dim, length) is None


def _check_cuda(qkv: torch.Tensor, heads: int, name: str) -> Tuple[int, int, int]:
    n, length, d = _geometry(qkv, heads)
    why = _refusal(qkv.dtype, d // heads, length)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous qkv on a 16-byte boundary, got "
                         f"strides {qkv.stride()} at {qkv.data_ptr() % 16} bytes past one")
    if n * heads >= _INT32:
        raise ValueError(f"{name}: {n} sequences of {heads} heads are too many for one launch")
    return n, length, d


def _launch(fn, name: str, pointers, n: int, length: int, heads: int, device) -> None:
    rc = fn(*(t.data_ptr() for t in pointers), n, length, heads, device.index,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _forward_kernel(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    name = "short_attention"
    # The span holds the whole call: checks, allocation and the launch.
    with span(SPAN):
        n, length, d = _check_cuda(qkv, heads, name)
        out = qkv.new_empty((n, length, d))
        if n == 0:
            return out
        _launch(_lib().asl_short_attention_fwd, name, (qkv, out), n, length, heads,
                qkv.device)
    short_attention.launches += 1
    return out


def _backward_kernel(grad_out: torch.Tensor, qkv: torch.Tensor, heads: int) -> torch.Tensor:
    name = "short_attention_backward"
    # The span holds the whole call, the pack below included.
    with span(SPAN):
        n, length, d = _check_cuda(qkv, heads, name)
        # The output projection's gradient is dense; a strided view of one
        # is packed first.
        grad_out = grad_out.contiguous()
        if (grad_out.dtype != qkv.dtype or grad_out.shape != (n, length, d)
                or grad_out.device != qkv.device or grad_out.data_ptr() % 16):
            raise ValueError(f"{name}: expected a bfloat16 gradient of shape {(n, length, d)} "
                             f"on {qkv.device}, got {grad_out.dtype} {tuple(grad_out.shape)} "
                             f"on {grad_out.device}")
        grad_qkv = torch.empty_like(qkv)
        if n == 0:
            return grad_qkv
        _launch(_lib().asl_short_attention_bwd, name, (grad_out, qkv, grad_qkv), n, length,
                heads, qkv.device)
    short_attention_backward.launches += 1
    return grad_qkv


# The ops join the namespace the preprocess ops define
# (``preprocess_kernels``), as a fragment of it.
_LIB = torch.library.Library("asltpu_torch", "FRAGMENT")
_LIB.define("short_attention(Tensor qkv, int heads) -> Tensor")
_LIB.define("short_attention_backward(Tensor grad_out, Tensor qkv, int heads) -> Tensor")
_LIB.impl("short_attention", short_attention_plain, "CPU")
_LIB.impl("short_attention", _forward_kernel, "CUDA")
_LIB.impl("short_attention_backward", short_attention_backward_plain, "CPU")
_LIB.impl("short_attention_backward", _backward_kernel, "CUDA")


@torch.library.register_fake("asltpu_torch::short_attention", lib=_LIB)
def _forward_fake(qkv, heads):
    n, length, d = _geometry(qkv, heads)
    return qkv.new_empty((n, length, d))


@torch.library.register_fake("asltpu_torch::short_attention_backward", lib=_LIB)
def _backward_fake(grad_out, qkv, heads):
    _geometry(qkv, heads)
    return torch.empty_like(qkv, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    qkv, heads = inputs
    ctx.save_for_backward(qkv)
    ctx.heads = heads


def _backward(ctx, grad):
    (qkv,) = ctx.saved_tensors
    return short_attention_backward(grad, qkv, ctx.heads), None


torch.library.register_autograd("asltpu_torch::short_attention", _backward,
                                setup_context=_setup_context, lib=_LIB)


def short_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention of each of ``heads`` heads over the sequences of the packed
    projection ``qkv`` [N, L, 3·d] → [N, L, d]: the op
    ``asltpu_torch::short_attention``, whose backward reads only ``qkv``."""
    return torch.ops.asltpu_torch.short_attention.default(qkv, heads)


short_attention.launches = 0


def short_attention_backward(grad_out: torch.Tensor, qkv: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """The gradient of ``qkv`` from the output's: the op
    ``asltpu_torch::short_attention_backward``."""
    return torch.ops.asltpu_torch.short_attention_backward.default(grad_out, qkv, heads)


short_attention_backward.launches = 0
