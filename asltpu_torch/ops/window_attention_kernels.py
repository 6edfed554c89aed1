"""Windowed self-attention with a relative-position bias read by index,
from the packed q/k/v projection: the wrapper of the hand-written CUDA
kernels (``asltpu_torch/csrc/window_attention.cu``), their plain PyTorch
versions, the custom ops and the launch counters.

The kernels replace no TPU kernel: the JAX package has no Video Swin. They
serve Video Swin's window sub-layers, each window's tokens over each other
with ``table[idx(i, j), h]`` added to the scaled scores and, in a shifted
block, −100 between two tokens of different regions: 31,744 (window, head)
pairs of 392 tokens a step of Video Swin-B at batch 8. On the card
PyTorch's memory-efficient attention read that bias materialised
[windows, heads, L, L] and wrote its gradient at that size, ≈ 3.7% of the
matmuls' roofline.

- ``asltpu_torch::window_attention(qkv, heads, table, window, regions) ->
  (out, out_rest, lse)``: ``qkv`` [N, L, 3·d] with columns q; k; v (what
  ``F.linear`` of a packed projection gives), each ``heads`` heads of
  d / heads, the N windows clip-major; ``table`` [rows, heads] the bias
  table; ``window`` the full window (Wd, Wh, Ww), whose first L tokens'
  coordinates give the relative-position index
  (:func:`relative_position_index`, sliced [:L, :L] for a clipped window);
  ``regions`` [nW, L] int32, one label a token of each of a clip's nW
  windows, or None. ``out`` [N, L, d] the heads side by side as the output
  projection reads them; ``out_rest`` what rounding the output to its dtype
  left, in that dtype (``out + out_rest`` holds the output to 16 bits, so
  that the backward's δ = rowsum(dO ∘ out) does not carry the output's
  rounding); ``lse`` [N, heads, L] fp32, each row's log-sum-exp. With
  ``register_autograd``; the backward saves ``qkv``, ``out``, ``out_rest``,
  ``lse``, ``table`` and ``regions``.
- ``asltpu_torch::window_attention_backward(grad_out, qkv, out, out_rest,
  lse, heads, table, window, regions) -> (grad_qkv, grad_table)``: the
  gradient of ``qkv`` in its own layout and of ``table`` in fp32, dS summed
  over the pairs that share a row, the windows and the clips.

Both have fake implementations. For a CPU tensor each op runs its plain
version, in the order of operations of
:func:`asltpu_torch.ops.attention.plain_attention` (the bias added in fp32,
the table's gradient scatter-added in fp32): :func:`window_attention_plain`
and :func:`window_attention_backward_plain`. For a CUDA tensor it launches
its kernel or raises ``ValueError`` before any launch: bf16 ``qkv``, heads
of :data:`HEAD_SIZE`, 1 ≤ L ≤ :data:`MAX_LEN`, a table of at most
:data:`MAX_ROWS` rows (:func:`kernel_takes`, which this module alone
states), fp32, L no more than the window's tokens, contiguous and 16-byte
aligned; no fallback. Which windows go to the op is decided in
:func:`asltpu_torch.ops.attention.attention`, which hands it a
:class:`WindowBias`. Each launch adds one to
``window_attention_kernel.launches`` or
``window_attention_kernel_backward.launches``; each call, from its checks to
its launch, runs inside the span ``attention.window``
(:func:`asltpu_torch.utils.profiling.span`).

Numerics on the card: bf16 in and out, fp32 products, bias and softmax
inside; P and dS enter their products as bf16 pairs hi + lo (16 bits), so
that the only roundings to bf16 are the inputs' and the results'; scale
1/√32. The table's gradient is summed with fp32 atomics, so its last bits
vary from run to run. Bound, on the card: the matmuls' operations at 989
TFLOP/s (q·kᵀ and P·v forward; 2.5 times that backward). The source file
says how the kernels go after it."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from asltpu_torch.ops import _build
from asltpu_torch.utils.profiling import span

# The span around each call of either direction.
SPAN = "attention.window"
# What the kernels take: heads of 32, up to 448 tokens a window, tables of up
# to 4096 rows (each staged in shared memory whole).
HEAD_SIZE = 32
MAX_LEN = 448
MAX_ROWS = 4096
# What the shifted windows add between tokens of two regions.
MASK_FILL = -100.0


class WindowBias(NamedTuple):
    """A window sub-layer's bias, by index: ``table`` [rows, heads] (the
    parameter), ``window`` the full window whose tokens' coordinates give
    the relative-position index, ``index`` [L·L] the same rows flat (the
    first L positions of the full window's index), ``regions`` [nW, L]
    int32 a label a token of each of a clip's nW windows (None where the
    block is not shifted) and ``mask`` [nW, L, L] the −100 mask those labels
    give, in the compute dtype. The kernel reads ``table``, ``window`` and
    ``regions``; the dense bias (:func:`dense_bias`) ``table``, ``index``
    and ``mask``."""

    table: torch.Tensor
    window: Tuple[int, int, int]
    index: torch.Tensor
    regions: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]


def table_rows(window: Sequence[int]) -> int:
    """Rows of the bias table of a window: (2Wd−1)(2Wh−1)(2Ww−1)."""
    return math.prod(2 * k - 1 for k in window)


def relative_position_index(window: Sequence[int], device) -> torch.Tensor:
    """[N, N] row of the bias table for each pair of a window's N tokens
    (d, h, w order): the offset along each axis, shifted to be
    non-negative, in mixed radix (2Wh−1)(2Ww−1), (2Ww−1), 1."""
    coords = torch.stack(torch.meshgrid(*(torch.arange(k, device=device) for k in window),
                                        indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    radix = ((2 * window[1] - 1) * (2 * window[2] - 1), 2 * window[2] - 1, 1)
    return sum((rel[i] + window[i] - 1) * radix[i] for i in range(3))


def region_mask(regions: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[nW, L, L]: 0 between two tokens of a window with one label, and
    :data:`MASK_FILL` between two with different labels."""
    return ((regions[:, None, :] != regions[:, :, None]) * MASK_FILL).to(dtype)


def dense_bias(bias: WindowBias, length: int, dtype: torch.dtype) -> torch.Tensor:
    """The bias materialised, [nW or 1, heads, L, L] in ``dtype``: the
    table gathered by the index (in the table's dtype, so that the
    gradient's sum over the pairs that share a row is taken in it too), cast
    to ``dtype``, plus the mask where the block is shifted."""
    dense = bias.table[bias.index].view(length, length, -1).permute(2, 0, 1)
    dense = (dense if dense.dtype == dtype else dense.to(dtype)).unsqueeze(0)
    return dense if bias.mask is None else dense + bias.mask.unsqueeze(1)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asl_window_attention_fwd.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.asl_window_attention_fwd.restype = i
    lib.asl_window_attention_bwd.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.asl_window_attention_bwd.restype = i
    return lib


def _geometry(qkv: torch.Tensor, heads: int) -> Tuple[int, int, int]:
    """(N, L, d) of a packed projection of ``heads`` heads; raises
    ``ValueError`` on any other shape."""
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"window_attention: expected qkv [N, L, 3·d] with d a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    n, length, width = qkv.shape
    return n, length, width // 3


def _heads(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """q, k, v of a packed projection as [N, H, L, D] views."""
    n, length, d = _geometry(qkv, heads)
    return qkv.view(n, length, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """fp32, or ``dtype`` where it is wider."""
    return torch.promote_types(dtype, torch.float32)


def _scores(qkv: torch.Tensor, heads: int, table: torch.Tensor, window: Sequence[int],
            regions: Optional[torch.Tensor]) -> torch.Tensor:
    """(q·kᵀ)·(1/√D) plus the bias, in fp32 (or the inputs' dtype where
    that is wider): [N, H, L, L]."""
    n, length, _ = _geometry(qkv, heads)
    q, k, _ = (t.to(_wide(qkv.dtype)) for t in _heads(qkv, heads))
    scores = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    index = relative_position_index(window, qkv.device)[:length, :length]
    bias = table[index].permute(2, 0, 1).to(_wide(table.dtype))
    if regions is None:
        return scores + bias
    bias = bias + region_mask(regions, bias.dtype).unsqueeze(1)
    w = regions.shape[0]
    return (scores.view(n // w, w, *scores.shape[1:]) + bias).view(scores.shape[0], -1,
                                                                   length, length)


def window_attention_plain(qkv: torch.Tensor, heads: int, table: torch.Tensor,
                           window: Sequence[int], regions: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention in plain PyTorch: (q·kᵀ)·(1/√D) plus the bias in fp32,
    softmax over the keys, times v in fp32 (or the inputs' dtype where that
    is wider), the heads laid side by side, rounded to the inputs' dtype;
    what that rounding left; and each row's log-sum-exp."""
    n, length, d = _geometry(qkv, heads)
    _, _, v = _heads(qkv, heads)
    wide = _wide(qkv.dtype)
    scores = _scores(qkv, heads, table, window, regions).to(wide)
    lse = torch.logsumexp(scores, dim=-1)
    exact = torch.matmul(scores.softmax(dim=-1), v.to(wide))
    exact = exact.transpose(1, 2).reshape(n, length, d)
    out = exact.to(qkv.dtype)
    return out, (exact - out.to(wide)).to(qkv.dtype), lse


def window_attention_backward_plain(grad_out: torch.Tensor, qkv: torch.Tensor,
                                    out: torch.Tensor, out_rest: torch.Tensor,
                                    lse: torch.Tensor, heads: int,
                                    table: torch.Tensor, window: Sequence[int],
                                    regions: Optional[torch.Tensor]
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``qkv`` and ``table`` in plain PyTorch, P recomputed
    from ``lse``: dv = Pᵀ·dO, dP = dO·vᵀ, dS = P ∘ (dP − δ) with δ =
    rowsum(dO ∘ (out + out_rest)), the table's gradient dS scatter-added by
    the index in fp32 over the windows, dq = dS·k/√D, dk = dSᵀ·q/√D, each in
    fp32 (or the inputs' dtype where that is wider), packed as q; k; v."""
    n, length, d = _geometry(qkv, heads)
    q, k, v = _heads(qkv, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    wide = _wide(qkv.dtype)
    p = (_scores(qkv, heads, table, window, regions).to(wide)
         - lse.to(wide).unsqueeze(-1)).exp()
    q, k, v = q.to(wide), k.to(wide), v.to(wide)
    do = grad_out.reshape(n, length, heads, d // heads).transpose(1, 2).to(wide)
    o = (out.to(wide) + out_rest.to(wide)).reshape(n, length, heads, d // heads).transpose(1, 2)
    dv = torch.matmul(p.transpose(-2, -1), do)
    dp = torch.matmul(do, v.transpose(-2, -1))
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    index = relative_position_index(window, qkv.device)[:length, :length].reshape(-1)
    grad_table = torch.zeros(table.shape, dtype=_wide(table.dtype), device=table.device)
    grad_table.index_add_(0, index, ds.sum(dim=0).permute(1, 2, 0).reshape(-1, heads)
                          .to(grad_table.dtype))
    ds = ds * scale
    dq, dk = torch.matmul(ds, k), torch.matmul(ds.transpose(-2, -1), q)
    grad_qkv = torch.stack((dq, dk, dv), dim=2).permute(0, 3, 2, 1, 4).reshape(n, length, 3 * d)
    return grad_qkv.to(qkv.dtype), grad_table.to(table.dtype)


def _refusal(dtype: torch.dtype, head_dim: int, length: int, rows: int) -> Optional[str]:
    """Why the kernels do not take windows of ``length`` tokens in heads of
    ``head_dim`` in ``dtype`` with a table of ``rows`` rows; None where they
    do."""
    if dtype != torch.bfloat16:
        return f"the kernels take bfloat16, got {dtype}"
    if head_dim != HEAD_SIZE:
        return f"the kernels take heads of {HEAD_SIZE}, got heads of {head_dim}"
    if not 1 <= length <= MAX_LEN:
        return f"the kernels take 1 to {MAX_LEN} tokens a window, got {length}"
    if rows > MAX_ROWS:
        return f"the kernels take tables of up to {MAX_ROWS} rows, got {rows}"
    return None


def kernel_takes(dtype: torch.dtype, head_dim: int, length: int, rows: int) -> bool:
    """Whether the kernels take windows of ``length`` tokens in heads of
    ``head_dim`` in ``dtype`` with a bias table of ``rows`` rows: bf16,
    heads of :data:`HEAD_SIZE`, 1 to :data:`MAX_LEN` tokens, at most
    :data:`MAX_ROWS` rows. A packed projection that ``F.linear`` wrote, an
    fp32 table and the model's regions also meet the layout the launch
    checks."""
    return _refusal(dtype, head_dim, length, rows) is None


def _check_cuda(qkv: torch.Tensor, heads: int, table: torch.Tensor, window: Sequence[int],
                regions: Optional[torch.Tensor], name: str) -> Tuple[int, int, int, int]:
    """(N, L, d, nW) of a launch; raises ``ValueError`` on what the kernels
    do not take."""
    n, length, d = _geometry(qkv, heads)
    why = _refusal(qkv.dtype, d // heads, length, table_rows(window))
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous qkv on a 16-byte boundary, got "
                         f"strides {qkv.stride()} at {qkv.data_ptr() % 16} bytes past one")
    if len(window) != 3 or math.prod(window) < length:
        raise ValueError(f"{name}: a window {tuple(window)} does not hold {length} tokens")
    shape = (table_rows(window), heads)
    if (table.dtype != torch.float32 or table.device != qkv.device or not table.is_contiguous()
            or tuple(table.shape) != shape):
        raise ValueError(f"{name}: expected a contiguous float32 table {shape} on {qkv.device}, "
                         f"got {table.dtype} {tuple(table.shape)} on {table.device}")
    if regions is not None and (
            regions.dtype != torch.int32 or regions.device != qkv.device
            or not regions.is_contiguous() or regions.dim() != 2 or regions.shape[1] != length
            or not regions.shape[0] or n % regions.shape[0]):
        raise ValueError(f"{name}: expected contiguous int32 regions [W, {length}] with W "
                         f"dividing {n} on {qkv.device}, got {regions.dtype} "
                         f"{tuple(regions.shape)} on {regions.device}")
    return n, length, d, 0 if regions is None else regions.shape[0]


def _launch(fn, name: str, pointers, ints, device) -> None:
    rc = fn(*(None if t is None else t.data_ptr() for t in pointers), *ints, device.index,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _forward_kernel(qkv, heads, table, window, regions):
    name = "window_attention"
    # The span holds the whole call: checks, allocation and the launch.
    with span(SPAN):
        n, length, d, w = _check_cuda(qkv, heads, table, window, regions, name)
        out, out_rest = qkv.new_empty((n, length, d)), qkv.new_empty((n, length, d))
        lse = torch.empty((n, heads, length), dtype=torch.float32, device=qkv.device)
        if n == 0:
            return out, out_rest, lse
        _launch(_lib().asl_window_attention_fwd, name,
                (qkv, table, regions, out, out_rest, lse), (n, length, heads, w, *window),
                qkv.device)
    window_attention_kernel.launches += 1
    return out, out_rest, lse


def _backward_kernel(grad_out, qkv, out, out_rest, lse, heads, table, window, regions):
    name = "window_attention_backward"
    # The span holds the whole call, the pack below included.
    with span(SPAN):
        n, length, d, w = _check_cuda(qkv, heads, table, window, regions, name)
        # The output projection's gradient is dense; a strided view of one
        # is packed first.
        grad_out = grad_out.contiguous()
        for t, what in ((grad_out, "gradient"), (out, "output"), (out_rest, "output's rest")):
            if (t.dtype != qkv.dtype or t.shape != (n, length, d) or t.device != qkv.device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name}: expected a contiguous bfloat16 {what} of shape "
                                 f"{(n, length, d)} on {qkv.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if (lse.dtype != torch.float32 or lse.shape != (n, heads, length)
                or lse.device != qkv.device or not lse.is_contiguous()):
            raise ValueError(f"{name}: expected a float32 lse {(n, heads, length)} on "
                             f"{qkv.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
        grad_qkv = torch.empty_like(qkv)
        grad_table = torch.zeros_like(table)
        if n == 0:
            return grad_qkv, grad_table
        _launch(_lib().asl_window_attention_bwd, name,
                (grad_out, qkv, out, out_rest, lse, table, regions, grad_qkv, grad_table),
                (n, length, heads, w, *window), qkv.device)
    window_attention_kernel_backward.launches += 1
    return grad_qkv, grad_table


# The ops join the namespace the preprocess ops define
# (``preprocess_kernels``), as a fragment of it.
_LIB = torch.library.Library("asltpu_torch", "FRAGMENT")
_LIB.define("window_attention(Tensor qkv, int heads, Tensor table, int[] window, "
            "Tensor? regions) -> (Tensor, Tensor, Tensor)")
_LIB.define("window_attention_backward(Tensor grad_out, Tensor qkv, Tensor out, "
            "Tensor out_rest, Tensor lse, int heads, Tensor table, int[] window, "
            "Tensor? regions) -> (Tensor, Tensor)")
_LIB.impl("window_attention", window_attention_plain, "CPU")
_LIB.impl("window_attention", _forward_kernel, "CUDA")
_LIB.impl("window_attention_backward", window_attention_backward_plain, "CPU")
_LIB.impl("window_attention_backward", _backward_kernel, "CUDA")


@torch.library.register_fake("asltpu_torch::window_attention", lib=_LIB)
def _forward_fake(qkv, heads, table, window, regions):
    n, length, d = _geometry(qkv, heads)
    return (qkv.new_empty((n, length, d)), qkv.new_empty((n, length, d)),
            qkv.new_empty((n, heads, length), dtype=_wide(qkv.dtype)))


@torch.library.register_fake("asltpu_torch::window_attention_backward", lib=_LIB)
def _backward_fake(grad_out, qkv, out, out_rest, lse, heads, table, window, regions):
    _geometry(qkv, heads)
    return (torch.empty_like(qkv, memory_format=torch.contiguous_format),
            torch.empty_like(table, memory_format=torch.contiguous_format))


def _setup_context(ctx, inputs, output):
    qkv, heads, table, window, regions = inputs
    ctx.save_for_backward(qkv, *output, table, regions)
    ctx.heads, ctx.window = heads, window


def _backward(ctx, grad, _grad_rest, _grad_lse):
    qkv, out, out_rest, lse, table, regions = ctx.saved_tensors
    grad_qkv, grad_table = window_attention_kernel_backward(grad, qkv, out, out_rest, lse,
                                                            ctx.heads, table, ctx.window,
                                                            regions)
    return grad_qkv, None, grad_table, None, None


torch.library.register_autograd("asltpu_torch::window_attention", _backward,
                                setup_context=_setup_context, lib=_LIB)


def window_attention_kernel(qkv: torch.Tensor, heads: int, table: torch.Tensor,
                            window: Sequence[int],
                            regions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of each of ``heads`` heads within each window of the packed
    projection ``qkv`` [N, L, 3·d] → [N, L, d], with the relative-position
    bias ``table`` read by the index of ``window`` and the mask of
    ``regions``: the op ``asltpu_torch::window_attention``, whose backward
    returns the table's gradient too."""
    return torch.ops.asltpu_torch.window_attention.default(qkv, heads, table, list(window),
                                                           regions)[0]


window_attention_kernel.launches = 0


def window_attention_kernel_backward(grad_out: torch.Tensor, qkv: torch.Tensor,
                                     out: torch.Tensor, out_rest: torch.Tensor,
                                     lse: torch.Tensor, heads: int,
                                     table: torch.Tensor, window: Sequence[int],
                                     regions: Optional[torch.Tensor] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``qkv`` and ``table`` from the output's: the op
    ``asltpu_torch::window_attention_backward``."""
    return torch.ops.asltpu_torch.window_attention_backward.default(
        grad_out, qkv, out, out_rest, lse, heads, table, list(window), regions)


window_attention_kernel_backward.launches = 0
