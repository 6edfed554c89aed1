"""The window attention op (``asltpu_torch/ops/window_attention_kernels.py``)
on the CPU, where it runs its plain version: against
``attention.plain_attention`` fed the bias materialised as the model's
dense path builds it (the table gathered by the index, plus the −100 mask),
forward, the gradient of the packed projection and the table's, shifted
and not, a clipped window, one window and several clips; the index the
kernels compute from the tokens' coordinates; what the kernels take
(``kernel_takes``); the op's fake; and ``attention`` with a window bias on
the CPU, which still takes the plain path. The kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""

import math

import pytest
import torch

from asltpu_torch.models import video_swin as vs
from asltpu_torch.ops import attention as att
from asltpu_torch.ops import short_attention_kernels as sa
from asltpu_torch.ops import window_attention_kernels as wk

# (full window, L, stage size the regions come from (None: unshifted),
# clips): one window; several clips; shifted (one window: the stage's last,
# which meets all its regions); a window clipped to its first L positions
# (the index sliced), shifted too.
CASES = {
    "one_window": ((2, 3, 4), 24, None, 1),
    "clips": ((2, 3, 4), 24, None, 3),
    "one_window_shifted": ((2, 3, 4), 24, (4, 6, 8), 1),
    "clips_shifted": ((2, 3, 4), 24, (4, 6, 8), 2),
    "clipped_shifted": ((4, 3, 4), 24, (2, 6, 8), 2),
}
HEADS, HEAD = 2, 8


def _case(name, dtype=torch.float64, seed=0):
    window, length, size, clips = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    regions = None
    if size is not None:
        clipped, shift = vs.clip_window(size, window, tuple(k // 2 for k in window))
        assert math.prod(clipped) == length
        regions = vs.shift_regions(size, clipped, shift, "cpu")
        if name.startswith("one_window"):
            regions = regions[-1:].contiguous()
        # Several regions in some window, or the mask would add nothing.
        assert bool((regions != regions[:, :1]).any())
    n = clips * (1 if regions is None else regions.shape[0])
    qkv = torch.randn((n, length, 3 * HEADS * HEAD), generator=gen, dtype=torch.float64)
    # A bias of the scores' own size, so that a wrong gather shows.
    table = torch.randn((wk.table_rows(window), HEADS), generator=gen, dtype=torch.float64)
    return qkv.to(dtype), table, window, regions


def _dense(table, window, length, regions, dtype):
    """The model's dense path: the bias gathered in the table's dtype, cast,
    plus the mask."""
    index = wk.relative_position_index(window, "cpu")[:length, :length].reshape(-1)
    mask = None if regions is None else wk.region_mask(regions, dtype)
    return wk.dense_bias(wk.WindowBias(table, window, index, regions, mask), length, dtype)


def _dense_attention(qkv, table, window, regions):
    """``plain_attention`` on q/k/v views with the dense bias repeated over
    the clips: [N, L, d]."""
    n, length, width = qkv.shape
    q, k, v = (qkv.view(n, length, 3, HEADS, HEAD)[:, :, i].transpose(1, 2) for i in range(3))
    bias = att.per_sequence(_dense(table, window, length, regions, qkv.dtype), n)
    return att.plain_attention(q, k, v, bias).transpose(1, 2).reshape(n, length, width // 3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_plain_forward_is_plain_attention_with_the_dense_bias(name):
    qkv, table, window, regions = _case(name)
    out = wk.window_attention_kernel(qkv, HEADS, table, window, regions)
    want = _dense_attention(qkv, table, window, regions)
    assert out.shape == want.shape and out.dtype == torch.float64
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
    _, rest, lse = torch.ops.asltpu_torch.window_attention(qkv, HEADS, table, list(window),
                                                           regions)
    assert not bool(rest.any())  # float64 is the output's own dtype
    n, length, _ = qkv.shape
    q, k, _ = (qkv.view(n, length, 3, HEADS, HEAD)[:, :, i].transpose(1, 2) for i in range(3))
    bias = att.per_sequence(_dense(table, window, length, regions, qkv.dtype), n)
    scores = q @ k.transpose(-2, -1) / math.sqrt(HEAD) + bias
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_plain_backward_is_the_dense_paths_gradient(name):
    """The op's autograd (its plain backward: P from the log-sum-exp, δ from
    the output, dS scatter-added into the table) against autograd through
    the gather, the mask and ``plain_attention``, for ``qkv`` and the
    table, in float64."""
    qkv, table, window, regions = _case(name, seed=1)
    grad = torch.randn((qkv.shape[0], qkv.shape[1], HEADS * HEAD), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))

    def grads(fn):
        x, t = qkv.clone().requires_grad_(), table.clone().requires_grad_()
        return torch.autograd.grad(fn(x, t), (x, t), grad)

    got = grads(lambda x, t: wk.window_attention_kernel(x, HEADS, t, window, regions))
    want = grads(lambda x, t: _dense_attention(x, t, window, regions))
    for g, w in zip(got, want):
        assert g.shape == w.shape and float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


def test_bf16_inputs_sum_the_table_gradient_in_fp32():
    """bf16 ``qkv`` with an fp32 table: the bias added and the table's
    gradient summed in fp32 (the table's dtype), within bf16's rounding of
    the products (2^-6 of the largest value) of the float64 result."""
    qkv, table, window, regions = _case("clips_shifted", seed=3)
    table = table.float()
    grad = torch.randn((qkv.shape[0], qkv.shape[1], HEADS * HEAD),
                       generator=torch.Generator().manual_seed(4))

    def run(x, t, g):
        x, t = x.clone().requires_grad_(), t.clone().requires_grad_()
        out = wk.window_attention_kernel(x, HEADS, t, window, regions)
        return (out, *torch.autograd.grad(out, (x, t), g))

    got = run(qkv.bfloat16(), table, grad.bfloat16())
    want = run(qkv, table.double(), grad.double())
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 2 ** -6 * float(w.abs().max())


@pytest.mark.parametrize("window,length", [((8, 7, 7), 392), ((8, 7, 7), 196),
                                           ((8, 7, 7), 100), ((4, 4, 4), 32),
                                           ((2, 3, 5), 30), ((4, 7, 7), 196)])
def test_the_index_is_the_tokens_coordinate_codes_difference(window, length):
    """What the kernels compute in place of reading the index: with c(t) =
    d·(2Wh−1)(2Ww−1) + h·(2Ww−1) + w for token t = (d, h, w) of the full
    window, idx(i, j) = c(i) − c(j) + c(Wd−1, Wh−1, Ww−1), for the first L
    tokens of a window, clipped (100: mid-plane) or not."""
    wd, wh, ww = window
    t = torch.arange(length)
    r1, r0 = 2 * ww - 1, (2 * wh - 1) * (2 * ww - 1)
    c = (t // (wh * ww)) * r0 + (t // ww) % wh * r1 + t % ww
    c0 = (wd - 1) * r0 + (wh - 1) * r1 + ww - 1
    want = wk.relative_position_index(window, "cpu")[:length, :length]
    assert torch.equal(c[:, None] - c[None, :] + c0, want)
    assert 2 * c0 + 1 == wk.table_rows(window)


@pytest.mark.parametrize("dtype,head,length,rows,takes", [
    (torch.bfloat16, 32, 392, 2535, True),   # Video Swin-B's windows
    (torch.bfloat16, 32, 196, 2535, True),   # a window clipped to 4 frames
    (torch.bfloat16, 32, 448, 4096, True),
    (torch.bfloat16, 32, 1, 1, True),
    (torch.float32, 32, 392, 2535, False),
    (torch.float16, 32, 392, 2535, False),
    (torch.bfloat16, 64, 392, 2535, False),
    (torch.bfloat16, 16, 392, 2535, False),
    (torch.bfloat16, 32, 449, 2535, False),
    (torch.bfloat16, 32, 0, 2535, False),
    (torch.bfloat16, 32, 392, 5239, False),  # a 16x7x7 window's table
])
def test_what_the_kernels_take(dtype, head, length, rows, takes):
    assert wk.kernel_takes(dtype, head, length, rows) is takes


def test_the_fakes_give_the_ops_shapes():
    """On the meta device the ops run their fakes: the output and its
    rest, an fp32 log-sum-exp a row, and gradients shaped as ``qkv`` and the
    table."""
    qkv = torch.empty((6, 392, 3 * 128), dtype=torch.bfloat16, device="meta")
    table = torch.empty((2535, 4), device="meta")
    regions = torch.empty((3, 392), dtype=torch.int32, device="meta")
    out, rest, lse = torch.ops.asltpu_torch.window_attention(qkv, 4, table, [8, 7, 7], regions)
    assert (out.shape, out.dtype, rest.shape, rest.dtype, lse.shape, lse.dtype) == (
        (6, 392, 128), torch.bfloat16, (6, 392, 128), torch.bfloat16, (6, 4, 392), torch.float32)
    grad_qkv, grad_table = torch.ops.asltpu_torch.window_attention_backward(
        out, qkv, out, rest, lse, 4, table, [8, 7, 7], None)
    assert (grad_qkv.shape, grad_table.shape, grad_table.dtype) == (
        qkv.shape, table.shape, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True], ids=["window", "shifted"])
def test_attention_on_the_cpu_takes_the_plain_path_with_a_window_bias(dtype, shifted):
    """``attention`` with a ``WindowBias`` on the CPU: the bias materialised
    as before (gather, cast, mask) and ``plain_attention``, one call; no
    window op, no biased, fused or short call, bit for bit the dense path."""
    qkv, table, window, regions = _case("clips_shifted" if shifted else "clips", seed=5)
    qkv, table = qkv.to(dtype), table.float()
    index = wk.relative_position_index(window, "cpu")[:24, :24].reshape(-1)
    mask = None if regions is None else wk.region_mask(regions, dtype)
    bias = wk.WindowBias(table, window, index, regions, mask)
    counters = lambda: (att.plain_attention.calls, att.biased_attention.calls,  # noqa: E731
                        att.fused_attention.calls, sa.short_attention.launches,
                        wk.window_attention_kernel.launches,
                        wk.window_attention_kernel_backward.launches)
    before = counters()
    got = att.attention(qkv, HEADS, bias)
    assert [a - b for a, b in zip(counters(), before)] == [1, 0, 0, 0, 0, 0]
    want = att.attention(qkv, HEADS, wk.dense_bias(bias, 24, dtype))
    assert got.dtype == dtype and torch.equal(got, want)
