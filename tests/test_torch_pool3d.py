"""I3D's 3D max-pool op (``asltpu_torch.ops.pool3d_kernels``) on the CPU:
the op's plain path against ``pad_same`` + ``F.max_pool3d`` forward and
backward at every pool form of I3D, a numpy emulation of the CUDA kernels'
algorithm (``csrc/pool3d.cu``: the forward's scan and tie rule, the
backward's gather over covering windows) against the plain version, the
fake implementations, the refusals, the registration and launch counters
without nvcc, and I3D's pools going through the op in a training step and
its rematerialised recompute (an export's program holds the op:
``tests/test_torch_export.py``). The kernels themselves run on the card:
``chip_smoke.py`` phase pool3d."""

import collections
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from asltpu_torch.models import i3d as ti3d
from asltpu_torch.models.common import pad_same, same_pads
from asltpu_torch.ops import pool3d_kernels as pk

CL = torch.channels_last_3d
# (kernel, stride, SAME or VALID): I3D's pools (after the stem and
# Conv3d_2c; the Inception blocks' branch 3; after Mixed_3c; after
# Mixed_4f), and a SAME form with pads (3, 3) and (2, 3) on a 7-tap axis.
FORMS = [((1, 3, 3), (1, 2, 2), "same"), ((3, 3, 3), (1, 1, 1), "same"),
         ((3, 3, 3), (2, 2, 2), "same"), ((2, 2, 2), (2, 2, 2), "valid"),
         ((3, 7, 1), (2, 2, 1), "same")]
# [N, C, T, H, W]: odd and even extents, C a multiple of 8, 132 (a
# tensor-parallel shard) and 3.
SHAPES = [(2, 16, 5, 7, 6), (1, 132, 4, 6, 5), (2, 3, 6, 5, 7), (1, 8, 2, 9, 4)]
OP = "asltpu_torch.max_pool3d_same.default"
BACKWARD_OP = "asltpu_torch.max_pool3d_same_backward.default"


def _pads(shape, kernel, stride, kind):
    if kind == "valid":
        return [0] * 6
    return [p for lo_hi in same_pads(shape[2:], kernel, stride) for p in lo_hi]


def _reference(x, kernel, stride, kind):
    """What I3D pooled with before the op: ``pad_same`` + ``F.max_pool3d``."""
    if kind == "valid":
        return F.max_pool3d(x, kernel, stride)
    padded, padding = pad_same(x, kernel, stride, float("-inf"))
    return F.max_pool3d(padded, kernel, stride, padding)


def _input(seed, shape, dtype, data="randn"):
    g = torch.Generator().manual_seed(seed)
    if data == "ties":  # three values: most windows hold their maximum more than once
        x = torch.randint(0, 3, shape, generator=g).float()
    else:
        x = torch.randn(shape, generator=g)
    if data == "nan":
        x[torch.rand(shape, generator=g) < 0.1] = float("nan")
    if data == "neginf":  # windows of −inf only among them
        x[torch.rand(shape, generator=g) < 0.7] = float("-inf")
    return x.to(dtype).contiguous(memory_format=CL)


@pytest.mark.parametrize("kernel,stride,kind", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,data", [(torch.float32, "randn"), (torch.float32, "ties"),
                                        (torch.float64, "randn"), (torch.bfloat16, "ties")])
def test_op_matches_pad_same_max_pool(kernel, stride, kind, shape, dtype, data):
    """The op's CPU path against ``pad_same`` + ``F.max_pool3d``: the same
    output, channels_last_3d, and the same input gradient (integer output
    gradients, so every sum is exact and ties must reach aten's element)."""
    pad = _pads(shape, kernel, stride, kind)
    x = _input(1, shape, dtype, data).requires_grad_()
    got = pk.max_pool3d_same(x, kernel, stride, pad)
    want = _reference(x, kernel, stride, kind)
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)
    g = torch.randint(-4, 5, got.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    (got_grad,) = torch.autograd.grad(got, x, g)
    (want_grad,) = torch.autograd.grad(want, x, g)
    assert got_grad.is_contiguous(memory_format=CL)
    assert torch.equal(got_grad, want_grad)


def _covering(i, pad, k, s, out):
    """pool3d.cu's ``covering``: the first and last window over index ``i``."""
    a = i + pad - k + 1
    lo = np.where(a <= 0, 0, (a + s - 1) // s)
    hi = np.minimum((i + pad) // s, out - 1)
    return lo, hi


def _emulate_forward(x, kernel, stride, pad):
    """pool3d.cu's ``max_pool3d_fwd`` in numpy on fp32 values [N, C, T, H, W]:
    per input plane and output (h, w), the maximum over the window's
    in-bounds KH × KW taps in (h, w) order, the first in-bounds tap the
    start and a tap taking over when it is greater or NaN, with its offset
    in the plane; then per output the planes of its window in t order, the
    first in-bounds plane's result the start and a later plane's taking
    over when its maximum is greater or NaN."""
    kt, kh, kw = kernel
    (st, sh, sw), (pt, ph, pw) = stride, pad[0::2]
    t, h, w = x.shape[2:]
    ot, oh, ow = pk.pool_geometry(x.shape[2:], kernel, stride, pad)
    y0, x0 = (np.arange(oh) * sh - ph)[:, None], (np.arange(ow) * sw - pw)[None, :]
    shape = x.shape[:3] + (oh, ow)
    plane_best = np.full(shape, -np.inf, np.float32)
    plane_arg = np.broadcast_to((np.maximum(y0, 0) - y0) * kw + np.maximum(x0, 0) - x0,
                                shape).copy()
    for dy, dx in itertools.product(range(kh), range(kw)):
        y, xx = y0 + dy, x0 + dx
        inside = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
        v = x[:, :, :, np.clip(y, 0, h - 1), np.clip(xx, 0, w - 1)]
        take = inside & ((plane_best < v) | np.isnan(v))
        plane_best = np.where(take, v, plane_best)
        plane_arg = np.where(take, dy * kw + dx, plane_arg)
    best = np.empty(x.shape[:2] + (ot, oh, ow), np.float32)
    arg = np.empty(best.shape, np.int64)
    for oz in range(ot):
        z0 = oz * st - pt
        za, zb = max(z0, 0), min(z0 + kt, t)
        m, a = plane_best[:, :, za], (za - z0) * kh * kw + plane_arg[:, :, za]
        for z in range(za + 1, zb):
            v = plane_best[:, :, z]
            take = (m < v) | np.isnan(v)
            m = np.where(take, v, m)
            a = np.where(take, (z - z0) * kh * kw + plane_arg[:, :, z], a)
        best[:, :, oz], arg[:, :, oz] = m, a
    return best, arg.astype(np.uint8)


def _emulate_backward(grad, offsets, size, kernel, stride, pad):
    """pool3d.cu's ``max_pool3d_bwd`` in numpy: each input element visits
    the windows that cover it in (t, h, w) order and adds, in fp32, the
    gradients whose offset points at it."""
    out_size = grad.shape[2:]
    idx = [np.arange(n)[sel] for n, sel in zip(
        size, [np.s_[:, None, None], np.s_[None, :, None], np.s_[None, None, :]])]
    ranges = [_covering(i, p, k, s, m) for i, p, k, s, m in zip(
        idx, pad[0::2], kernel, stride, out_size)]
    acc = np.zeros(grad.shape[:2] + tuple(size), np.float32)
    steps = [-(-k // s) for k, s in zip(kernel, stride)]
    for jz, jy, jx in itertools.product(*(range(n) for n in steps)):
        o = [lo + j for (lo, _), j in zip(ranges, (jz, jy, jx))]
        inside = np.ones(tuple(size), bool)
        for a, (_, hi) in zip(o, ranges):
            inside = inside & (a <= hi)
        oz, oy, ox = (np.minimum(a, m - 1) for a, m in zip(o, out_size))
        d = [i - (a * s - p) for i, a, s, p in zip(idx, (oz, oy, ox), stride, pad[0::2])]
        want = (d[0] * kernel[1] + d[1]) * kernel[2] + d[2]
        hit = inside & (offsets[:, :, oz, oy, ox] == want)
        acc += np.where(hit, grad[:, :, oz, oy, ox], 0.0).astype(np.float32)
    return acc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("data", ["randn", "ties", "nan", "neginf"])
def test_kernel_algorithm_matches_plain(shape, data):
    """The kernels' algorithm, emulated, against the op's plain version at
    every form: the forward's values (NaN where the plain has NaN) and its
    offsets exactly, ties, NaNs and windows of −inf only included; the
    backward's gather within fp32 rounding of the plain scatter-add."""
    x = _input(3, shape, torch.float32, data)
    for kernel, stride, kind in FORMS:
        pad = _pads(shape, kernel, stride, kind)
        out, offsets = pk.max_pool3d_plain(x, kernel, stride, pad)
        best, arg = _emulate_forward(x.numpy(), kernel, stride, pad)
        np.testing.assert_array_equal(best, out.numpy())
        np.testing.assert_array_equal(arg, offsets.numpy())
        g = _input(4, out.shape, torch.float32)
        want = pk.max_pool3d_backward_plain(g, offsets, shape[2:], kernel, stride, pad)
        got = _emulate_backward(g.numpy(), arg, shape[2:], kernel, stride, pad)
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


def test_offsets_keep_the_first_maximum_and_the_last_nan():
    """The tie rule in one window of 3³: equal values give the first in
    (t, h, w) order; NaN beats any number, and the last NaN wins."""
    x = torch.zeros(1, 1, 3, 3, 3)
    x[0, 0, 1, 0, 2] = x[0, 0, 2, 2, 2] = 5.0
    out, off = pk.max_pool3d_plain(x, (3, 3, 3), (1, 1, 1), [0] * 6)
    assert out.item() == 5.0 and off.item() == (1 * 3 + 0) * 3 + 2
    x[0, 0, 0, 1, 1] = x[0, 0, 2, 0, 0] = float("nan")
    out, off = pk.max_pool3d_plain(x, (3, 3, 3), (1, 1, 1), [0] * 6)
    assert out.isnan().item() and off.item() == (2 * 3 + 0) * 3 + 0
    best, arg = _emulate_forward(x.numpy(), (3, 3, 3), (1, 1, 1), [0] * 6)
    assert np.isnan(best).all() and arg.item() == off.item()


@pytest.mark.parametrize("kernel,stride,kind", FORMS)
def test_fake_gives_shape_dtype_and_strides(kernel, stride, kind):
    """Both ops' fake implementations against their CPU results: shape,
    dtype and channels_last_3d strides."""
    shape = (2, 16, 5, 7, 6)
    pad = _pads(shape, kernel, stride, kind)
    x = _input(5, shape, torch.bfloat16)
    out, off = torch.ops.asltpu_torch.max_pool3d_same.default(x, kernel, stride, pad)
    grad_in = torch.ops.asltpu_torch.max_pool3d_same_backward.default(
        out, off, shape[2:], kernel, stride, pad)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fx = torch.empty(shape, dtype=torch.bfloat16, memory_format=CL)
        fout, foff = torch.ops.asltpu_torch.max_pool3d_same.default(fx, kernel, stride, pad)
        fgrad = torch.ops.asltpu_torch.max_pool3d_same_backward.default(
            fout, foff, shape[2:], kernel, stride, pad)
    for real, fake in ((out, fout), (off, foff), (grad_in, fgrad)):
        assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    assert off.dtype == torch.uint8 and fgrad.shape == shape


@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3, 3), (1, 1, 1), [1, 1, 1, 1, 2, 1]),  # lo > hi
    ((3, 3, 3), (1, 1, 1), [0, 3, 0, 0, 0, 0]),  # hi == k
    ((7, 7, 7), (1, 1, 1), [0] * 6),  # 343 taps: no one-byte offset
    ((3, 3), (1, 1), [0] * 6),
])
def test_op_refuses_what_it_does_not_take(kernel, stride, pad):
    with pytest.raises(ValueError, match="max_pool3d_same"):
        pk.max_pool3d_same(_input(6, (1, 2, 8, 8, 8), torch.float32), kernel, stride, pad)


@pytest.mark.parametrize("x,kernel", [
    (torch.zeros(1, 8, 4, 4, 4, dtype=torch.float16).contiguous(memory_format=CL), (3, 3, 3)),
    (torch.zeros(1, 8, 4, 4, 4, dtype=torch.bfloat16), (3, 3, 3)),  # NCDHW memory
    (torch.zeros(8, 4, 4, 4, dtype=torch.bfloat16), (3, 3, 3)),
    (torch.zeros(1, 8, 4, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL), (3, 1, 3)),
    (torch.zeros(1, 6, 4, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL), (3, 3, 3)),
    (torch.zeros(1, 6, 4, 4, 4, dtype=torch.float32).contiguous(memory_format=CL), (3, 3, 3)),
    # One value past an aligned start: C = 8 in channels_last_3d memory.
    (torch.zeros(1 + 8 * 4 ** 3, dtype=torch.bfloat16)[1:].view(1, 4, 4, 4, 8)
     .permute(0, 4, 1, 2, 3), (3, 3, 3)),
])
def test_kernel_path_refuses_before_launching(x, kernel):
    """What the CUDA implementation refuses, checked before any build or
    launch: other dtypes, memory formats, ranks and windows, and a C or an
    alignment that no access width of the kernels fits."""
    with pytest.raises(ValueError, match="max_pool3d_same"):
        pk._forward_kernel(x, kernel, (1, 1, 1), [1] * 6)
    assert pk.max_pool3d_same.launches == 0
    assert pk._lib.cache_info().currsize == 0


@pytest.mark.parametrize("c,dtype,offset,want", [
    (64, torch.bfloat16, 0, 8), (132, torch.bfloat16, 0, 4), (64, torch.bfloat16, 4, 4),
    (132, torch.float32, 0, 4), (6, torch.bfloat16, 0, None), (64, torch.float32, 2, None),
])
def test_access_width_follows_channels_and_alignment(c, dtype, offset, want):
    """bf16 moves 8 values a thread where C and every pointer allow 16
    bytes, else 4; fp32 moves 4; anything narrower is refused."""
    x = torch.zeros(offset + c * 8, dtype=dtype)[offset:]
    if want is None:
        with pytest.raises(ValueError, match="multiple of 4"):
            pk._vec("max_pool3d_same", c, x)
    else:
        assert pk._vec("max_pool3d_same", c, x) == want


def test_registration_and_counters_need_no_nvcc():
    """Importing the module registers both ops and sets the counters; CPU
    calls move no counter and build nothing."""
    assert hasattr(torch.ops.asltpu_torch, "max_pool3d_same")
    assert hasattr(torch.ops.asltpu_torch, "max_pool3d_same_backward")
    x = _input(7, (1, 8, 4, 5, 5), torch.float32).requires_grad_()
    pk.max_pool3d_same(x, (3, 3, 3), (1, 1, 1), [1] * 6).sum().backward()
    assert pk.max_pool3d_same.launches == pk.max_pool3d_same_backward.launches == 0
    assert pk._lib.cache_info().currsize == 0


class _OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,forward_calls", [(False, 13), (True, 13 + 9)])
def test_i3d_step_pools_through_the_op(remat, forward_calls):
    """A training step of full-width I3D (8 frames of 32²) calls the op for
    all 13 pools and its backward 13 times; with remat the recompute of the
    9 Inception blocks calls it again for their branch-3 pools; no aten
    max-pool remains."""
    model = ti3d.I3D(num_classes=5, dropout=0.0, remat=remat)
    clip = torch.randn(1, 8, 32, 32, 3, generator=torch.Generator().manual_seed(8))
    with _OpCounts() as counts:
        model(clip, train=True).sum().backward()
    assert counts.calls[OP] == forward_calls
    assert counts.calls[BACKWARD_OP] == 13
    assert not [name for name in counts.calls if "max_pool3d" in name and "aten" in name]
