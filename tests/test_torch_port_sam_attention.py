"""The fused SAM attention (`ops/kernels/sam_attention.py`) on the CPU: its
plain version against `SamAttention`'s written-out path, the route
`_attend` takes, the wrapper's argument checks, and the launch path's
plans, C arguments and counters with the CUDA kernel replaced by the plain
version (the kernel itself runs only on a card: `chip_smoke.py` phase 21).

Bar, fp32: 1e-6 of the largest output. The plain version computes what the
written-out path computes, in the same order (the scaled product, the
tables added in place, the softmax, the product with v); measured 0. The
bf16 encoder through the launch path against its written-out self: 2e-2
of the largest output (measured 0.013), where the two round the scores
(bf16 against fp32) and the probabilities (normalised against not) at
different places.
"""

import math

import pytest
import torch
import torch.distributed as dist

from equiadapt_tpu_torch.models import sam_encoder as se
from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import sam_attention as sa
from equiadapt_tpu_torch.utils import profiling
from torch_port_cpu import one_intra_op_thread  # noqa: F401

FP32_BAR = 1e-6
BF16_BAR = 2e-2
DIM, HEADS = 128, 2  # heads of 64, SAM ViT-B's width
# (grid H, W): global 8 x 8 and 16 x 16; SAM's 14 x 14 window (N 196 is no
# multiple of the kernel's key tile of 64, so its keys past N are masked)
GRIDS = {"global8": (8, 8), "global16": (16, 16), "window14": (14, 14)}


def _fused_is_plain(monkeypatch):
    """`_attend` takes its fused branch, whose call is the plain version:
    the branch's arguments (q, k, v by strides, the tables' shapes) on the
    CPU."""
    monkeypatch.setattr(sa, "attention_path", lambda *args: "fused")
    monkeypatch.setattr(sa, "sam_attention", sa.sam_attention_plain)


def _module(H, W, use_rel_pos, seed=0, cls=se.SamAttention):
    torch.manual_seed(seed)
    m = se.SamAttention(DIM, HEADS, (H, W), use_rel_pos=use_rel_pos, device="cpu")
    for p in m.parameters():  # tables of 0.5: the bias moves the softmax
        torch.nn.init.normal_(p, std=0.5)
    m.__class__ = cls
    return m


def _x(H, W, B=3, seed=1):
    return torch.randn(B, H, W, DIM, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("use_rel_pos", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("grid", list(GRIDS), ids=list(GRIDS))
def test_plain_version_against_the_written_out_attention(grid, use_rel_pos, monkeypatch):
    H, W = GRIDS[grid]
    m, x = _module(H, W, use_rel_pos), _x(H, W)
    before = profiling.counters().get("sam/attn_score_elems", 0)
    with torch.no_grad():
        written = m._attend(x)
    assert profiling.counters()["sam/attn_score_elems"] - before == 3 * HEADS * (H * W) ** 2
    _fused_is_plain(monkeypatch)
    with torch.no_grad():
        fused = m._attend(x)
    assert profiling.counters()["sam/attn_score_elems"] - before == 3 * HEADS * (H * W) ** 2
    assert fused.shape == written.shape == (3, H * W, DIM)
    assert (fused - written).abs().max() <= FP32_BAR * written.abs().max()


def test_plain_version_alone():
    """sam_attention_plain on q, k, v and tables made by hand, against the
    formula written with explicit indices."""
    g = torch.Generator().manual_seed(3)
    B, H, W, nh, hd = 2, 3, 5, 2, 4
    N = H * W
    q, k, v = (torch.randn(B, N, nh, hd, generator=g) for _ in range(3))
    rh, rw = torch.randn(B, nh, N, H, generator=g), torch.randn(B, nh, N, W, generator=g)
    got = sa.sam_attention_plain(q, k, v, rh, rw, H, W).view(B, N, nh, hd)
    j = torch.arange(N)
    for b in range(B):
        for h in range(nh):
            s = q[b, :, h] @ k[b, :, h].T / math.sqrt(hd) + rh[b, h][:, j // W] + rw[b, h][:, j % W]
            want = torch.softmax(s, -1) @ v[b, :, h]
            assert (got[b, :, h] - want).abs().max() <= FP32_BAR * want.abs().max()


@pytest.mark.parametrize("grid", ["global8", "window14"])
def test_tp_attention_at_world_one(grid, tmp_path, monkeypatch):
    """`TPSamAttention` inherits the route: with its local heads (all of
    them at world 1) the fused branch equals the written-out one."""
    from equiadapt_tpu_torch.parallel.tp import _tp_classes

    H, W = GRIDS[grid]
    tp_cls = _tp_classes()[se.SamAttention]
    m = _module(H, W, True, cls=tp_cls)
    m.tp_group = None  # the default group: the world of one
    x = _x(H, W, B=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with torch.no_grad():
            written = m(x)
            _fused_is_plain(monkeypatch)
            fused = m(x)
    finally:
        dist.destroy_process_group()
    assert fused.shape == (2, H, W, DIM)
    assert (fused - written).abs().max() <= FP32_BAR * written.abs().max()


@pytest.mark.parametrize("device, dtype, grad, hd, grid, path", [
    ("cuda", torch.bfloat16, False, 64, (64, 64), "fused"),
    ("cuda:0", torch.bfloat16, False, 64, (14, 14), "fused"),
    ("cuda", torch.bfloat16, False, 80, (64, 64), "written"),
    ("cuda", torch.float32, False, 64, (64, 64), "written"),
    ("cpu", torch.bfloat16, False, 64, (64, 64), "written"),
    ("cpu", torch.float32, False, 64, (14, 14), "written"),
    ("meta", torch.bfloat16, False, 64, (64, 64), "written"),
    ("cuda", torch.bfloat16, True, 64, (64, 64), "written"),
    ("cuda", torch.float16, False, 64, (64, 64), "written"),
    ("cuda", torch.bfloat16, False, 24, (64, 64), "written"),
    ("cuda", torch.bfloat16, False, 64, (400, 400), "written"),
])
def test_route_decision(device, dtype, grad, hd, grid, path):
    """The kernel for a bf16 card call that needs no gradient at a shape
    it takes; the written-out path for every other, a head width or grid
    the kernel has no plan for included (no call raises that used to run)."""
    assert sa.attention_path(torch.device(device), dtype, grad, hd, *grid) == path


@pytest.mark.parametrize("hd, H, W, takes", [
    (64, 64, 64, True), (64, 14, 14, True), (64, 1, 1, True), (64, 7, 9, True),
    (80, 64, 64, False), (32, 14, 14, False), (128, 64, 64, False),
    (64, 128, 128, True), (64, 129, 129, False), (64, 30, 300, False)])
def test_kernel_takes(hd, H, W, takes):
    """Head widths of HEAD_DIMS over grids whose two tables fit the block's
    shared memory."""
    assert sa.kernel_takes(hd, H, W) == takes
    _, mt, _ = sa._plan(1, H * W, 1)
    assert (sa._smem(hd, mt, H, W, True) <= sa.MAX_SMEM) == (takes or hd not in sa.HEAD_DIMS)


def test_needs_grad():
    a = torch.ones(2, requires_grad=True)
    b = torch.ones(2)
    assert sa.needs_grad(a, None)
    assert not sa.needs_grad(b, None)
    with torch.no_grad():
        assert not sa.needs_grad(a, b)


def test_attend_routes_cpu_bf16_and_grad_calls_to_the_written_path():
    """On the CPU every call writes its scores out (the counter grows), in
    bf16 and with a gradient alike; the gradient reaches the tables."""
    m, x = _module(8, 8, True), _x(8, 8)
    before = profiling.counters().get("sam/attn_score_elems", 0)
    with torch.no_grad():
        assert m._attend(x.bfloat16()).dtype == torch.bfloat16
    out = m._attend(x)
    out.sum().backward()
    assert m.rel_pos_h.grad is not None and bool(m.rel_pos_h.grad.abs().sum() > 0)
    assert profiling.counters()["sam/attn_score_elems"] - before == 2 * 3 * HEADS * 64 ** 2


def _qkv(B=2, H=4, W=4, nh=2, hd=64, dtype=torch.bfloat16):
    N = H * W
    qkv = torch.randn(B, N, 3, nh, hd).to(dtype)
    q, k, v = qkv.unbind(2)
    return q, k, v, torch.randn(B, nh, N, H).to(dtype), torch.randn(B, nh, N, W).to(dtype)


@pytest.mark.parametrize("case", ["qk_shape", "grid", "one_table", "table_shape", "dtypes"])
def test_argument_checks(case):
    q, k, v, rh, rw = _qkv()
    args = {"qk_shape": (q, k[:, :8], v, rh, rw, 4, 4),
            "grid": (q, k, v, rh, rw, 4, 3),
            "one_table": (q, k, v, rh, None, 4, 4),
            "table_shape": (q, k, v, rh[..., :3], rw, 4, 4),
            "dtypes": (q, k, v.float(), rh, rw, 4, 4)}[case]
    with pytest.raises(TypeError if case == "dtypes" else ValueError):
        sa.sam_attention(*args)


@pytest.mark.parametrize("case", ["fp32", "head_width", "q_stride", "table_stride",
                                  "q_words", "large_grid"])
def test_launch_checks(case):
    """What the kernel refuses beyond the plain version's checks: another
    dtype than bf16, a head width or grid it has no plan for, an operand
    whose last dimension is not contiguous, q rows that are not whole
    16-byte words."""
    H = W = 4
    if case == "fp32":
        args, err = _qkv(dtype=torch.float32), TypeError
    elif case == "head_width":
        args, err = _qkv(hd=24), ValueError
    elif case == "q_stride":
        q, k, v, rh, rw = _qkv()
        q = torch.randn(2, 16, 2, 128).bfloat16()[..., ::2]
        args, err = (q, k, v, rh, rw), ValueError
    elif case == "table_stride":
        q, k, v, rh, rw = _qkv()
        rh = torch.randn(2, 2, 4, 16).bfloat16().transpose(-1, -2)
        args, err = (q, k, v, rh, rw), ValueError
    elif case == "q_words":
        q, k, v, rh, rw = _qkv()
        q = torch.randn(2, 16, 2, 68).bfloat16()[..., 2:66]  # rows 136 bytes apart
        args, err = (q, k, v, rh, rw), ValueError
    else:
        H = W = 300
        args, err = _qkv(B=1, H=H, W=W, nh=1), ValueError
    with pytest.raises(err):
        sa._validate_launch(*args, H, W)


@pytest.mark.parametrize("B, N, nh, plan, mt, grid", [
    (8, 4096, 12, "global", 2, (96, 32)),
    (200, 196, 12, "window", 1, (2400, 4)),
    (3, 1024, 2, "global", 2, (6, 8)),
    (3, 1023, 2, "window", 1, (6, 16)),
    (5462, 2, 12, "window", 1, (65544, 1)),
])
def test_plan(B, N, nh, plan, mt, grid):
    """The tile plan from N, and the grid: B x heads on its first
    dimension (up to 2^31 - 1), the query tiles on its second."""
    assert sa._plan(B, N, nh) == (plan, mt, grid)


def test_c_arguments():
    """`eqt_sam_attention`'s arguments: pointers, the 17 strides in the
    source's `Strides` order (q, k, v, rel_h, rel_w by batch, token or
    table row, head; the output by batch and token), then heads, N, hd, H,
    W, MT and the grid."""
    q, k, v, rh, rw = _qkv(B=3, H=2, W=4, nh=2)
    out = torch.empty(3, 8, 128, dtype=torch.bfloat16)
    args = sa._c_args(q, k, v, rh, rw, out, 2, 4, 1, (6, 1))
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
                        rw.data_ptr(), out.data_ptr())
    assert list(args[6]) == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                             *rh.stride()[:3], *rw.stride()[:3], 8 * 128, 128]
    assert q.stride()[:3] == (8 * 3 * 128, 3 * 128, 64)  # read from the qkv output
    assert args[7:] == (2, 8, 64, 2, 4, 1, 6, 1)
    nobias = sa._c_args(q, k, v, None, None, out, 2, 4, 1, (6, 1))
    assert nobias[3] is None and nobias[4] is None


def test_meta_and_device_routes():
    q, k, v, rh, rw = (t.to("meta") for t in _qkv())
    with _build.shapes_only():
        out = sa.sam_attention(q, k, v, rh, rw, 4, 4)
    assert out.device.type == "meta" and out.shape == (2, 16, 128)
    with pytest.raises(RuntimeError):
        sa.sam_attention(q, k, v, rh, rw, 4, 4)


def test_the_wrapper_refuses_cpu_tensors():
    """On the CPU the wrapper raises: `SamAttention` writes the attention
    out there, and the plain version is called by name."""
    with pytest.raises(RuntimeError, match="card only"):
        sa.sam_attention(*_qkv(), 4, 4)


class _PlainKernel:
    """Stands in for the CUDA launch: records each launch's plan and grid
    and writes the plain version into the output."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, rh, rw, out, H, W, mt, grid):
        B, N, nh, hd = q.shape
        self.calls.append(dict(grid=grid, mt=mt, H=H, W=W, N=N, nh=nh, hd=hd,
                               bias=rh is not None))
        out.copy_(sa.sam_attention_plain(q, k, v, rh, rw, H, W))


@pytest.fixture
def card(monkeypatch):
    """The wrapper's launch path on the CPU: bf16 calls at shapes the
    kernel takes route to it, and the launch is `_PlainKernel`."""
    kernel = _PlainKernel()
    monkeypatch.setattr(sa, "_kernel", kernel)
    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    monkeypatch.setattr(
        sa, "attention_path",
        lambda device, dtype, grad, hd, H, W: "fused" if (
            dtype == torch.bfloat16 and not grad and sa.kernel_takes(hd, H, W)) else "written")
    sa.reset_launches()
    yield kernel
    sa.reset_launches()


def test_launch_arguments(card):
    q, k, v, rh, rw = _qkv(B=3, H=14, W=14, nh=2)
    out = sa.sam_attention(q, k, v, rh, rw, 14, 14)
    (call,) = card.calls
    assert call == dict(grid=(6, 4), mt=1, H=14, W=14, N=196, nh=2, hd=64, bias=True)
    assert out.shape == (3, 196, 128) and out.dtype == torch.bfloat16
    assert sa.launches == {"sam_attention/bfloat16": 1}
    assert sa.path_launches == {"sam_attention/bfloat16/window": 1}


def test_launch_grid_past_the_second_dimension(card):
    """B x heads above 65535 (the second grid dimension's limit) launches:
    the heads lie on the first dimension."""
    B, nh = 5462, 12
    q, k, v, rh, rw = _qkv(B=B, H=1, W=2, nh=nh)
    out = sa.sam_attention(q, k, v, rh, rw, 1, 2)
    (call,) = card.calls
    assert call["grid"] == (B * nh, 1) and B * nh > 65535
    assert out.shape == (B, 2, nh * 64)


def test_encoder_counters_on_the_fused_path(card):
    """A bf16 encoder with one windowed (14 x 14 windows of a 32 x 32 grid,
    padded to 42 x 42) and one global block (N 1024, the long plan): one
    launch each by its plan, no score written out, `counters()` reports
    them; its output against the same encoder's written-out path."""
    torch.manual_seed(4)
    enc = se.SamVitEncoder(img_size=256, patch_size=8, embed_dim=DIM, depth=2,
                           num_heads=HEADS, out_chans=16, window_size=14,
                           global_attn_indexes=(1,), device="cpu", dtype=torch.bfloat16)
    for blk in enc.blocks:
        torch.nn.init.normal_(blk.attn.rel_pos_h, std=0.5)
        torch.nn.init.normal_(blk.attn.rel_pos_w, std=0.5)
    x = torch.rand(2, 256, 256, 3)
    before = profiling.counters()
    with torch.no_grad():
        fused = enc(x).float()
    after = profiling.counters()
    assert after.get("sam/attn_score_elems", 0) == before.get("sam/attn_score_elems", 0)
    assert after["paths/sam_attention/bfloat16/global"] == 1
    assert after["paths/sam_attention/bfloat16/window"] == 1
    assert after["launches/sam_attention/bfloat16"] == 2
    assert [(c["N"], c["mt"]) for c in card.calls] == [(196, 1), (1024, 2)]
    with torch.enable_grad():  # needs a gradient: the written-out path
        written = enc(x).float().detach()
    assert sa.launches == {"sam_attention/bfloat16": 2}
    assert (fused - written).abs().max() <= BF16_BAR * written.abs().max()
