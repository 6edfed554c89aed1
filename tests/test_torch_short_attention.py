"""The short-sequence attention op (``asltpu_torch.ops.short_attention_kernels``)
on the CPU: its plain path against ``plain_attention`` on the q/k/v views of
the packed projection, forward and gradient; a lane-level emulation of the
CUDA kernels' algorithm (``csrc/short_attention.cu``: ldmatrix and mma.sync
fragments, the masked softmax in the accumulators, the staged transposes)
against exact math; the fake implementations; what the card path refuses
before any build or launch; the registration and counters without nvcc;
what the kernels take (``kernel_takes``); and ``attention(qkv, heads)``,
directly and through TimeSformer's ``Attention``, sending short sequences
to the op and long ones to the q/k/v views. The kernels themselves run on
the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase short_attention."""

import collections

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from asltpu_torch.models import timesformer as tsf
from asltpu_torch.ops import attention as att
from asltpu_torch.ops import short_attention_kernels as sa

OP = "asltpu_torch.short_attention.default"
BACKWARD_OP = "asltpu_torch.short_attention_backward.default"


def _qkv(seed, n, length, heads, dtype=torch.float32, head=64):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, length, 3 * heads * head), generator=gen).to(dtype)


def _views_attention(qkv, heads):
    n, length, width = qkv.shape
    qkv5 = qkv.view(n, length, 3, heads, width // (3 * heads))
    q, k, v = (qkv5[:, :, i].transpose(1, 2) for i in range(3))
    return att.plain_attention(q, k, v).transpose(1, 2).reshape(n, length, width // 3)


@pytest.mark.parametrize("n,length,heads,head", [
    (3, 1, 2, 64), (2, 5, 3, 64), (4, 16, 12, 64), (2, 32, 1, 16),
])
def test_plain_path_matches_the_views_attention(n, length, heads, head):
    """The op on the CPU (its plain version) against ``plain_attention`` on
    q, k, v views of the same projection, as ``Attention`` made them
    before: the output, and the gradient of ``qkv`` through the op's own
    backward against autograd's through the views, in fp32."""
    qkv = _qkv(length, n, length, heads, head=head).requires_grad_()
    before = att.plain_attention.calls
    got = sa.short_attention(qkv, heads)
    assert att.plain_attention.calls == before
    want = _views_attention(qkv, heads)
    assert got.shape == want.shape == (n, length, heads * head)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (g_got,) = torch.autograd.grad(got, qkv, grad)
    (g_want,) = torch.autograd.grad(want, qkv, grad)
    assert g_got.shape == qkv.shape and g_got.is_contiguous()
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-5)


# A lane-level emulation of csrc/short_attention.cu. Registers are (lo, hi)
# pairs of bf16 values; a warp's lane 4g + t holds rows g and g + 8, columns
# 2t and 2t + 1 of an accumulator tile.
KROW = 72
LANES = np.arange(32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _ldmatrix(tile, address, trans):
    """ldmatrix.x4: lane l gives the (row, column) of row l % 8 of matrix
    l / 8; each lane receives, per matrix, its row g's columns 2t, 2t + 1
    (trans: column g's rows 2t, 2t + 1)."""
    rows = [address(lane) for lane in range(32)]
    regs = np.zeros((32, 4, 2), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            if trans:
                (r0, c0), (r1, c1) = rows[8 * i + 2 * t], rows[8 * i + 2 * t + 1]
                regs[lane, i] = tile[r0, c0 + g], tile[r1, c1 + g]
            else:
                r, c = rows[8 * i + g]
                regs[lane, i] = tile[r, c + 2 * t:c + 2 * t + 2]
    return regs


def _mma(acc, a, b0, b1):
    """mma.sync m16n8k16: acc [32, 4] += A (16×16) B (16×8) in fp32."""
    A, B, C = np.zeros((16, 16)), np.zeros((16, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 8 + 2 * t),
                                    (g + 8, 8 + 2 * t))):
            A[r, c:c + 2] = a[lane, i]
        B[2 * t:2 * t + 2, g], B[8 + 2 * t:10 + 2 * t, g] = b0[lane], b1[lane]
        C[g, 2 * t:2 * t + 2], C[g + 8, 2 * t:2 * t + 2] = acc[lane, :2], acc[lane, 2:]
    D = (A @ B + C).astype(np.float32)
    return np.stack([np.concatenate((D[lane >> 2, 2 * (lane & 3):2 * (lane & 3) + 2],
                                     D[(lane >> 2) + 8, 2 * (lane & 3):2 * (lane & 3) + 2]))
                     for lane in range(32)])


def _a_rows(tile, m0, k0):
    return _ldmatrix(tile, lambda l: (m0 + (l & 7) + 8 * ((l >> 3) & 1), k0 + 8 * (l >> 4)),
                     False)


def _a_cols(tile, m0, k0):
    return _ldmatrix(tile, lambda l: (k0 + (l & 7) + 8 * (l >> 4), m0 + 8 * ((l >> 3) & 1)),
                     True)


def _b_rows(tile, n0, k0):
    return _ldmatrix(tile, lambda l: (n0 + (l & 7) + 8 * (l >> 4), k0 + 8 * ((l >> 3) & 1)),
                     False)


def _b_cols(tile, k0, n0):
    return _ldmatrix(tile, lambda l: (k0 + (l & 7) + 8 * ((l >> 3) & 1), n0 + 8 * (l >> 4)),
                     True)


def _scores(sa_tile, sb_tile, m0, lp):
    s = np.zeros((lp // 8, 32, 4), np.float32)
    for k0 in range(0, 64, 16):
        a = _a_rows(sa_tile, m0, k0)
        for j in range(0, lp // 8, 2):
            b = _b_rows(sb_tile, 8 * j, k0)
            s[j] = _mma(s[j], a, b[:, 0], b[:, 1])
            s[j + 1] = _mma(s[j + 1], a, b[:, 2], b[:, 3])
    return s


def _row_reduce(v, op):
    v = op(v, v[LANES ^ 1])
    return op(v, v[LANES ^ 2])


def _softmax_numerators(s, length, lp):
    cols = 8 * np.arange(lp // 8)[:, None, None] + 2 * (LANES & 3)[None, :, None] + (
        np.arange(4) & 1)[None, None, :]
    s = np.where(cols < length, s * np.float32(0.125 * 1.4426950408889634), -np.inf)
    half = [s[:, :, :2], s[:, :, 2:]]
    mx = [_row_reduce(h.max(axis=(0, 2)), np.maximum) for h in half]
    p = np.concatenate([np.exp2(h - m[None, :, None]) for h, m in zip(half, mx)], axis=2)
    sums = [_row_reduce(p[:, :, 2 * i:2 * i + 2].sum(axis=(0, 2)), np.add) for i in (0, 1)]
    return p.astype(np.float32), sums


def _scale_rows(acc, lo, hi):
    return np.concatenate([acc[:, :, :2] * lo[None, :, None], acc[:, :, 2:] * hi[None, :, None]],
                          axis=2)


def _a_from_acc(s, kk):
    return _bf16(np.stack([s[2 * kk][:, :2], s[2 * kk][:, 2:], s[2 * kk + 1][:, :2],
                           s[2 * kk + 1][:, 2:]], axis=1))


def _times_cols(ksteps, a_of, tile):
    acc = np.zeros((8, 32, 4), np.float32)
    for kk in range(ksteps):
        a = a_of(kk)
        for j in range(0, 8, 2):
            b = _b_cols(tile, 16 * kk, 8 * j)
            acc[j] = _mma(acc[j], a, b[:, 0], b[:, 1])
            acc[j + 1] = _mma(acc[j + 1], a, b[:, 2], b[:, 3])
    return acc


def _stage(tile, m0, acc):
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(acc.shape[0]):
            tile[m0 + g, 8 * j + 2 * t:8 * j + 2 * t + 2] = _bf16(acc[j, lane, :2])
            tile[m0 + g + 8, 8 * j + 2 * t:8 * j + 2 * t + 2] = _bf16(acc[j, lane, 2:])


def _tile(x, lp):
    t = np.zeros((lp, KROW), np.float32)
    t[:x.shape[0], :64] = x
    return t


def _emulate_forward(q, k, v):
    length = q.shape[0]
    lp = 16 if length <= 16 else 32
    sq, sk, sv = _tile(q, lp), _tile(k, lp), _tile(v, lp)
    for m0 in range(0, lp, 16):
        s, sums = _softmax_numerators(_scores(sq, sk, m0, lp), length, lp)
        o = _times_cols(lp // 16, lambda kk: _a_from_acc(s, kk), sv)
        _stage(sq, m0, _scale_rows(o, 1 / sums[0], 1 / sums[1]))
    return sq[:length, :64]


def _emulate_backward(q, k, v, do):
    length = q.shape[0]
    lp = 16 if length <= 16 else 32
    sq, sk, sv, sdo = (_tile(x, lp) for x in (q, k, v, do))
    sp, sds = np.zeros((lp, lp + 8), np.float32), np.zeros((lp, lp + 8), np.float32)
    for m0 in range(0, lp, 16):
        p, sums = _softmax_numerators(_scores(sq, sk, m0, lp), length, lp)
        p = _scale_rows(p, 1 / sums[0], 1 / sums[1])
        dp = _scores(sdo, sv, m0, lp)
        delta = [_row_reduce((p * dp)[:, :, 2 * i:2 * i + 2].sum(axis=(0, 2)), np.add)
                 for i in (0, 1)]
        ds = p * (dp - np.concatenate([np.broadcast_to(d[None, :, None], (lp // 8, 32, 2))
                                       for d in delta], axis=2)) * np.float32(0.125)
        _stage(sp, m0, p)
        _stage(sds, m0, ds.astype(np.float32))
    grads = []
    for tile, a_of in ((sk, lambda m0, kk: _a_rows(sds, m0, 16 * kk)),   # dq = dS k
                       (sq, lambda m0, kk: _a_cols(sds, m0, 16 * kk)),   # dk = dSᵀ q
                       (sdo, lambda m0, kk: _a_cols(sp, m0, 16 * kk))):  # dv = Pᵀ dO
        out = np.zeros((lp, KROW), np.float32)
        for m0 in range(0, lp, 16):
            _stage(out, m0, _times_cols(lp // 16, lambda kk: a_of(m0, kk), tile))
        grads.append(out[:length, :64])
    return grads


@pytest.mark.parametrize("length", [1, 7, 16, 17, 32])
def test_emulated_kernels_match_exact_attention(length):
    """The kernels' algorithm, lane by lane (fragments as ldmatrix and
    mma.sync lay them out, keys past L masked, rows past L zero-filled),
    on one head of bf16 values: the output and q, k, v's gradients within
    2^-6 of each tensor's largest value of float64 autograd (bf16 rounds P
    and dS by 2^-9 each; a wrong fragment or mask misses by the tensor's
    own size)."""
    rng = np.random.default_rng(length)
    q, k, v, do = (_bf16(rng.standard_normal((length, 64))) for _ in range(4))
    q64, k64, v64 = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                     for x in (q, k, v))
    out = torch.softmax(q64 @ k64.T / 8, dim=-1) @ v64
    want = (out, *torch.autograd.grad(out, (q64, k64, v64), torch.tensor(do, dtype=torch.float64)))
    got = (_emulate_forward(q, k, v), *_emulate_backward(q, k, v, do))
    for g, w in zip(got, want):
        w = w.detach().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2 ** -6 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("n,length,heads", [(5, 16, 12), (2, 32, 3)])
def test_fakes_give_the_kernels_shapes(n, length, heads):
    qkv = _qkv(0, n, length, heads, torch.bfloat16)
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(qkv)
        out = torch.ops.asltpu_torch.short_attention.default(fq, heads)
        grad = torch.ops.asltpu_torch.short_attention_backward.default(out, fq, heads)
    assert (tuple(out.shape), out.dtype, out.is_contiguous()) == (
        (n, length, heads * 64), torch.bfloat16, True)
    assert (tuple(grad.shape), grad.dtype, grad.is_contiguous()) == (
        tuple(qkv.shape), torch.bfloat16, True)


@pytest.mark.parametrize("dtype,head_dim,length,takes", [
    (torch.bfloat16, 64, 16, True), (torch.bfloat16, 64, 32, True),
    (torch.bfloat16, 64, 33, False), (torch.float32, 64, 16, False),
    (torch.bfloat16, 32, 16, False), (torch.bfloat16, 64, 0, False),
])
def test_kernel_takes_bf16_heads_of_64_up_to_32_tokens(dtype, head_dim, length, takes):
    assert sa.kernel_takes(dtype, head_dim, length) is takes


@pytest.mark.parametrize("qkv,heads,match", [
    (_qkv(0, 2, 16, 2, torch.float32), 2, "bfloat16"),
    (_qkv(0, 2, 16, 4, torch.bfloat16, head=32), 4, "heads of 64"),
    (_qkv(0, 2, 33, 2, torch.bfloat16), 2, "1 to 32 tokens"),
    (_qkv(0, 2, 0, 2, torch.bfloat16), 2, "1 to 32 tokens"),
    (_qkv(0, 16, 2, 2, torch.bfloat16).transpose(0, 1), 2, "contiguous"),
    (torch.zeros(1 + 2 * 16 * 384, dtype=torch.bfloat16)[1:].view(2, 16, 384), 2, "16-byte"),
    (_qkv(0, 2, 16, 2, torch.bfloat16)[..., :-1], 2, "multiple of"),
])
def test_kernel_path_refuses_before_launching(qkv, heads, match):
    """What the CUDA implementation refuses, either direction, checked before
    any build or launch: fp32, heads other than 64, more than 32 tokens (or
    none), a strided or unaligned projection, a width no head count
    divides."""
    with pytest.raises(ValueError, match=match):
        sa._forward_kernel(qkv, heads)
    grad = torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        sa._backward_kernel(grad, qkv, heads)
    assert sa.short_attention.launches == sa.short_attention_backward.launches == 0
    assert sa._lib.cache_info().currsize == 0


def test_registration_and_counters_need_no_nvcc():
    """Importing the module registers both ops and sets the counters; CPU
    calls, forward and backward, move no counter and build nothing."""
    assert hasattr(torch.ops.asltpu_torch, "short_attention")
    assert hasattr(torch.ops.asltpu_torch, "short_attention_backward")
    qkv = _qkv(3, 2, 16, 2).requires_grad_()
    sa.short_attention(qkv, 2).sum().backward()
    assert sa.short_attention.launches == sa.short_attention_backward.launches == 0
    assert sa._lib.cache_info().currsize == 0


class _OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("length,short", [(16, True), (32, True), (33, False), (785, False)])
def test_attention_dispatches_by_sequence_length(length, short):
    """On the CPU ``attention(qkv, heads)`` sends a sequence of at most 32
    tokens (the temporal sub-layer's 16) to the op, forward and backward,
    and a longer one (the spatial sub-layer's 785) to ``plain_attention``
    on q, k, v views; both give the views' attention. TimeSformer's
    ``Attention`` does the same through it."""
    qkv = _qkv(length, 2, length, 2).requires_grad_()
    before = att.plain_attention.calls
    with _OpCounts() as counts:
        got = att.attention(qkv, 2)
        got.sum().backward()
    assert (counts.calls[OP], counts.calls[BACKWARD_OP]) == ((1, 1) if short else (0, 0))
    assert att.plain_attention.calls == before + (0 if short else 1)
    torch.testing.assert_close(got.detach(), _views_attention(qkv.detach(), 2), rtol=0,
                               atol=1e-6)

    block = tsf.Attention(128, 2)
    x = torch.randn((2, length, 128), generator=torch.Generator().manual_seed(length),
                    requires_grad=True)
    before = att.plain_attention.calls
    with _OpCounts() as counts:
        y = block(x)
        y.sum().backward()
    assert (counts.calls[OP], counts.calls[BACKWARD_OP]) == ((1, 1) if short else (0, 0))
    assert att.plain_attention.calls == before + (0 if short else 1)
    qkv = torch.nn.functional.linear(x.detach(), block.qkv.weight, block.qkv.bias)
    want = torch.nn.functional.linear(_views_attention(qkv, 2), block.proj.weight,
                                      block.proj.bias)
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=1e-5)
