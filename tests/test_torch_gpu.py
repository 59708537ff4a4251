"""Card-only tests of the port's CUDA kernels against their plain versions,
at small shapes that reach the kernels' edges (ragged chunks and runs,
strided rows, narrow heads, even conv kernels, ragged query and key
lengths, strided views of a split projection, every dtype; seedvr2's
shape and route), and the SSD,
the Mamba-1 scans, the shared bidirectional scan and the depthwise conv +
SiLU also at the shapes the served paths give them; the exact time-sharded
fast_mamba_vsr on a one-rank NCCL group; the temporal stage's Farneback
flow and ``temporal_smooth`` on the card against the CPU.

They carry the ``gpu`` marker and skip without a card. This file imports no
JAX, so on the card's machine (which has none) it runs with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.models import (ditvr, fast_mamba_vsr, rvrt,
                                             seedvr2)
from video_enhancer_tpu_torch.nn.ssm import (bimamba_apply, bimamba_init,
                                             bissd_apply, bissd_init,
                                             bissm_apply, bissm_init,
                                             ssm_apply)
from video_enhancer_tpu_torch.ops.attention import (_flash_operands,
                                                    _flash_plan, _flash_smem,
                                                    _window_plan,
                                                    attention, attention_ref,
                                                    flash_attention,
                                                    window_attention,
                                                    window_attention_plain)
from video_enhancer_tpu_torch.ops.conv import (_dwconv_plan, _dwconv_smem,
                                               depthwise_conv1d_silu,
                                               depthwise_conv1d_silu_plain)
from video_enhancer_tpu_torch.ops.scan import (
    _FUSED_INSTANCES, _bidir_plan, _bidir_smem, _fused_bissm_plan,
    _fused_smem, _on_16_byte_grid, _shared_scan_plan, _short_scan_plan,
    _tile_smem,
    fused_bidir_ssm_kernel, fused_bidir_ssm_plain, selective_scan,
    selective_scan_assoc, selective_scan_bidir, selective_scan_bidir_plain,
    selective_scan_bidir_shared, selective_scan_bidir_shared_plain,
    selective_scan_pallas, selective_scan_pallas_short, selective_scan_plain)
from video_enhancer_tpu_torch.ops.ssd import (_ssd_plan, _ssd_smem,
                                              ssd_shared_kernel,
                                              ssd_shared_plain)

pytestmark = pytest.mark.gpu

# max |kernel - plain| / max |plain|
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,L,H,P,N", [(2, 300, 2, 64, 16), (1, 64, 1, 32, 8),
                                       (3, 1, 2, 16, 4), (2, 1000, 4, 48, 32)])
def test_ssd_kernel_matches_plain(cuda, dtype, reverse, b, L, H, P, N):
    gen = torch.Generator(device=cuda).manual_seed(L + N)
    xbc = torch.randn((b, L, H * P + 2 * N + 3), generator=gen,
                      device=cuda).to(dtype)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    Bm = xbc[..., H * P:H * P + N]
    Cm = xbc[..., H * P + N:H * P + 2 * N]
    dt = 0.001 + 0.2 * torch.rand((b, L, H), generator=gen, device=cuda)
    A = -(0.2 + 2 * torch.rand((H,), generator=gen, device=cuda))
    before = kernels.launch_counts["ssd_shared"]
    got = ssd_shared_kernel(x, dt, A, Bm, Cm, reverse=reverse)
    ref = ssd_shared_plain(x, dt, A, Bm, Cm, reverse=reverse)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ssd_shared"] == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert _rel(got, ref) <= TOL[dtype]


def _ssd_case(cuda, dtype, b, L, H, P, N, extra, seed):
    """x, dt, A, B, C with x, B and C column slices of one (b, L, H*P + 2N
    + extra) tensor: extra 0 is the served conv output (rows of 16-byte
    multiples), 3 puts every row off the 16-byte grid."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn((b, L, H * P + 2 * N + extra), generator=gen,
                      device=cuda).to(dtype)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    Bm = xbc[..., H * P:H * P + N]
    Cm = xbc[..., H * P + N:H * P + 2 * N]
    dt = 0.001 + 0.2 * torch.rand((b, L, H), generator=gen, device=cuda)
    A = -(0.2 + 2 * torch.rand((H,), generator=gen, device=cuda))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("b,L,H,P,N", [
    (2, 1, 2, 64, 16), (3, 37, 2, 64, 16),       # L below the chunk
    (1, 64 * 5 + 7, 2, 64, 16),                  # b 1, a ragged last chunk
    (2, 64 * 300 + 5, 2, 64, 16),                # runs of two chunks
    (2, 700, 2, 32, 16), (2, 700, 4, 32, 8),     # P 32; N 8
    (2, 700, 1, 64, 8), (2, 700, 8, 16, 16)])    # one head; eight
def test_ssd_tensor_core_path_matches_plain(cuda, dtype, reverse, extra, b, L,
                                            H, P, N):
    """The tensor-core path (bf16 / fp16) against the plain version at the
    edges of its chunks, runs and tiles, forward and reverse, with x, B
    and C read in place by 16-byte copies (extra 0) and by elements."""
    x, dt, A, Bm, Cm = _ssd_case(cuda, dtype, b, L, H, P, N, extra, L + N)
    plan = _ssd_plan(b, L, H, P, N, dtype, kernels.sm_count(x.device))
    assert plan["route"] == "mma"
    got = ssd_shared_kernel(x, dt, A, Bm, Cm, reverse=reverse)
    ref = ssd_shared_plain(x, dt, A, Bm, Cm, reverse=reverse)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_tensor_core_path_at_the_served_shape(cuda, reverse):
    """vsrm's spatial SSD in bf16 (b 7, L 57600, H 2, P 64, N 16, the conv
    output's column slices): runs of 17 chunks, against the plain version
    and, as a control, far from the scan the other way."""
    x, dt, A, Bm, Cm = _ssd_case(cuda, torch.bfloat16, 7, 57600, 2, 64, 16,
                                 0, 0)
    assert _ssd_plan(7, 57600, 2, 64, 16, torch.bfloat16,
                     kernels.sm_count(x.device))["run"] > 1
    got = ssd_shared_kernel(x, dt, A, Bm, Cm, reverse=reverse)
    ref = ssd_shared_plain(x, dt, A, Bm, Cm, reverse=reverse)
    other = ssd_shared_plain(x, dt, A, Bm, Cm, reverse=not reverse)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL[torch.bfloat16]
    assert _rel(other, ref) > 5 * TOL[torch.bfloat16]


@pytest.mark.parametrize("H,P", [(2, 64), (1, 32), (4, 32), (8, 16)])
def test_ssd_smem_mirrors_the_kernel(cuda, H, P):
    assert kernels.library().vetk_ssd_tc_smem(H, P) == _ssd_smem(H, P)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,L,D,N,K,r", [(300, 7, 128, 4, 5, 4),
                                         (17, 32, 96, 8, 4, 6),
                                         (5, 1, 32, 16, 3, 1)])
def test_fused_bissm_kernel_matches_plain(cuda, dtype, B, L, D, N, K, r):
    gen = torch.Generator(device=cuda).manual_seed(B + L)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    u, gate = rnd(B, L, 2 * D).to(dtype).chunk(2, dim=-1)
    args = (u, gate, rnd(D, 1, K, scale=0.3), rnd(D, scale=0.1),
            rnd(r + 2 * N, D, scale=0.2), rnd(D, r, scale=0.2),
            rnd(D, scale=0.1), rnd(D, scale=0.1) - 2, rnd(D, scale=0.1) - 2,
            -torch.exp(rnd(D, N, scale=0.3)), -torch.exp(rnd(D, N, scale=0.3)),
            rnd(D), rnd(D), r)
    before = kernels.launch_counts["fused_bidir_ssm"]
    got = fused_bidir_ssm_kernel(*args)
    ref = fused_bidir_ssm_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["fused_bidir_ssm"] == before + 1
    assert _rel(got, ref) <= TOL[dtype]


def _fused_args(cuda, B, L, D, N, K, r, dtype, wdtype, seed, offset=0):
    """u_pre and gate as the two halves of one (B, L, 2D) projection (row
    stride 2D; shifted by ``offset`` elements off the 16-byte grid), the
    weights in ``wdtype``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    xz = rnd(B, L, 2 * D + offset).to(dtype)[..., offset:]
    u, gate = xz.chunk(2, dim=-1)
    w = (rnd(D, 1, K, scale=0.3), rnd(D, scale=0.1),
         rnd(r + 2 * N, D, scale=0.2), rnd(D, r, scale=0.2),
         rnd(D, scale=0.1), rnd(D, scale=0.1) - 2, rnd(D, scale=0.1) - 2,
         -torch.exp(rnd(D, N, scale=0.3)), -torch.exp(rnd(D, N, scale=0.3)),
         rnd(D), rnd(D))
    return (u, gate, *(t.to(wdtype) for t in w), r)


# (D, N, K, dt_rank): vsrm's instance, fast_mamba_vsr's, the generic one at
# its bounds and a narrow one
FUSED_INSTANCE_CASES = [(128, 4, 5, 4), (96, 8, 5, 3), (256, 16, 8, 16),
                        (32, 16, 3, 1)]


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 7, 16, 32])
@pytest.mark.parametrize("B", [1, 7, 1000])
@pytest.mark.parametrize("D,N,K,r", FUSED_INSTANCE_CASES)
def test_fused_bissm_instances_match_plain(cuda, D, N, K, r, B, L, dtype,
                                           wdtype):
    """Every instance (the specialised ones where N, K, dt_rank, D and L
    fit them, the generic one otherwise), B of 1, 7 and 1000 (not a
    multiple of the warps a block), strided u and gate, weights in fp32 and
    in bf16; one launch a call."""
    args = _fused_args(cuda, B, L, D, N, K, r, dtype, wdtype, seed=B + L + D)
    before = kernels.launch_counts["fused_bidir_ssm"]
    got = fused_bidir_ssm_kernel(*args)
    ref = fused_bidir_ssm_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["fused_bidir_ssm"] == before + 1
    assert got.shape == (B, L, D) and got.dtype == dtype
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [57600, 57595])
@pytest.mark.parametrize("L,D,N,K,r", [(7, 128, 4, 5, 4), (16, 96, 8, 5, 3)])
def test_fused_bissm_at_the_served_shapes(cuda, L, D, N, K, r, B, dtype):
    """vsrm's and fast_mamba_vsr's shapes, with B a multiple of the warps a
    block and not."""
    args = _fused_args(cuda, B, L, D, N, K, r, dtype, dtype, seed=L)
    got = fused_bidir_ssm_kernel(*args)
    ref = fused_bidir_ssm_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bissm_reads_rows_off_the_16_byte_grid(cuda, dtype):
    """u and gate one element off the 16-byte grid take the kernel's plain
    copies instead of cp.async."""
    args = _fused_args(cuda, 300, 7, 128, 4, 5, 4, dtype, torch.float32,
                       seed=3, offset=1)
    assert args[0].data_ptr() % 16
    got = fused_bidir_ssm_kernel(*args)
    ref = fused_bidir_ssm_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D", [(7, 128), (16, 96), (32, 256), (1, 1)])
def test_fused_bissm_plan_mirrors_the_kernel(cuda, dtype, L, D):
    """The plan's shared memory is the kernel's own sum, for every
    instance, and the plan launches a block the card takes."""
    lib = kernels.library()
    code = kernels.dtype_code(torch.empty((), dtype=dtype))
    item = torch.empty((), dtype=dtype).element_size()
    for index in range(len(_FUSED_INSTANCES)):
        regs = lib.vetk_fused_bissm_regs(code, index)
        assert 0 < regs <= 255
        for warps in (1, 4):
            assert (lib.vetk_fused_bissm_smem(code, index, L, D, warps)
                    == _fused_smem(index, L, D, item, warps))
    plan = _fused_bissm_plan(57600, L, D, 4, 5, 4, item,
                             kernels.sm_count(cuda), regs=128)
    assert plan["smem"] <= 232448


def test_layers_route_through_kernels(cuda):
    """bissd in bf16 launches the SSD kernel twice; bissm launches the fused
    kernel once; both agree with their plain paths."""
    gen = torch.Generator().manual_seed(0)
    pd = {k: v.to(cuda) if torch.is_tensor(v) else
          {kk: vv.to(cuda) for kk, vv in v.items()}
          for k, v in bissd_init(gen, 64, state_dim=16).items()}
    pm = {k: v.to(cuda) if torch.is_tensor(v) else
          {kk: vv.to(cuda) for kk, vv in v.items()}
          for k, v in bissm_init(gen, 64).items()}
    x = torch.randn((2, 200, 64), device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = bissd_apply(pd, x)
    assert kernels.launch_counts["ssd_shared"] == 2
    assert _rel(y, bissd_apply(pd, x, use_kernel=False)) <= 3e-2
    s = torch.randn((300, 7, 64), device=cuda).bfloat16()
    z = bissm_apply(pm, s)
    assert kernels.launch_counts["fused_bidir_ssm"] == 1
    assert _rel(z, bissm_apply(pm, s, impl="plain")) <= 2e-2


def test_kernel_rejects_bad_layout(cuda):
    """A head dimension that is not dense is refused, not misread."""
    x = torch.randn((1, 10, 64, 2), device=cuda).transpose(2, 3)
    dt = torch.rand((1, 10, 2), device=cuda)
    Bm = torch.randn((1, 10, 4), device=cuda)
    with pytest.raises(ValueError, match="heads must be dense"):
        ssd_shared_kernel(x, dt, -torch.ones(2, device=cuda), Bm, Bm)


# flash attention: max |kernel - attention_ref| / max |attention_ref|. In
# half types both round the probabilities to the input type, the kernel
# before it divides by the running sum and the plain form after, so they
# differ by about that rounding; fp32 differs only in the order of sums.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _qkv(cuda, dtype, B, H, Lq, Lk, Dh, layout, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if layout == "dense":
        return [torch.randn((B, H, n, Dh), generator=gen, device=cuda)
                .to(dtype) for n in (Lq, Lk, Lk)]
    # views of wider projections, as ditvr hands them over: (B, L, H, Dh)
    # column slices seen as (B, H, L, Dh), head dim dense; "odd" shifts
    # them by one element, off the 16-byte grid
    off = 1 if layout == "odd" else 0
    xq = torch.randn((B, Lq, H * Dh + 8 + off), generator=gen, device=cuda)
    xkv = torch.randn((B, Lk, 2 * H * Dh + off), generator=gen, device=cuda)
    xq, xkv = xq.to(dtype)[..., off:], xkv.to(dtype)[..., off:]

    def mh(z, n):
        return z.reshape(B, n, H, Dh).transpose(1, 2)

    k, v = xkv.chunk(2, dim=-1)
    return mh(xq[..., :H * Dh], Lq), mh(k, Lk), mh(v, Lk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("split", ["dense", "split", "odd"])
@pytest.mark.parametrize("B,H,Lq,Lk,Dh", [(2, 3, 300, 1000, 64),
                                          (1, 2, 37, 53, 16),
                                          (2, 3, 256, 256, 128),
                                          (1, 1, 1, 70, 48),
                                          (3, 2, 129, 65, 112)])
def test_flash_kernel_matches_plain(cuda, dtype, split, B, H, Lq, Lk, Dh):
    q, k, v = _qkv(cuda, dtype, B, H, Lq, Lk, Dh, split, seed=Lq + Lk)
    before = kernels.launch_counts["flash_attention"]
    got = flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    assert got.shape == (B, H, Lq, Dh) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= FLASH_TOL[dtype]


FLASH_LENGTHS = [1, 63, 127, 128, 129, 300, 1000]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Dh", [16, 48, 64, 128])
@pytest.mark.parametrize("Lk", FLASH_LENGTHS)
@pytest.mark.parametrize("Lq", FLASH_LENGTHS)
def test_flash_wgmma_kernel_at_tile_edges(cuda, Lq, Lk, Dh, dtype):
    """Query and key lengths on both sides of the 128-row tiles, every
    padded width (64: Dh 16-64; 128: Dh 128), views of a split projection
    read in place; one launch a call."""
    q, k, v = _qkv(cuda, dtype, 2, 3, Lq, Lk, Dh, "split", seed=7 * Lq + Lk)
    assert _flash_plan(2, 3, Lq, Lk, Dh, 2, _flash_operands(
        q=q, k=k, v=v, o=q))["copy"] == ()
    before = kernels.launch_counts["flash_attention"]
    got = flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    assert got.shape == (2, 3, Lq, Dh) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_copies_what_tma_cannot_read(cuda, dtype):
    """Views one element off the 16-byte grid are copied once to dense
    tensors (the plan says which) and give the plain version's result."""
    q, k, v = _qkv(cuda, dtype, 2, 3, 300, 1000, 64, "odd", seed=5)
    plan = _flash_plan(2, 3, 300, 1000, 64, 2,
                       _flash_operands(q=q, k=k, v=v, o=q.contiguous()))
    assert plan["copy"] == ("q", "k", "v")
    before = kernels.launch_counts["flash_attention"]
    got = flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    assert _rel(got, ref) <= FLASH_TOL[dtype]


def test_flash_plan_mirrors_the_kernel(cuda):
    lib = kernels.library()
    for dhp in (64, 128):
        assert lib.vetk_flash_smem(dhp) == _flash_smem(dhp, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_scale_and_large_logits(cuda, dtype):
    """A given scale is used, and logits far from 0 stay finite."""
    q, k, v = _qkv(cuda, dtype, 1, 2, 70, 130, 32, "dense", seed=9)
    got = flash_attention(q * 30, k, v, scale=0.7)
    ref = attention_ref(q * 30, k, v, scale=0.7)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= FLASH_TOL[dtype]


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn((1, 1, 20, 40), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q, q, q)
    x = torch.randn((1, 1, 64, 20), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="head dim must be dense"):
        flash_attention(x, x, x)
    with pytest.raises(TypeError):
        flash_attention(x.contiguous(), x.contiguous().half(),
                        x.contiguous())


def test_attention_dispatch_on_the_card(cuda):
    """The kernel for unbiased Lq, Lk >= 256; the plain form otherwise."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 2, 256, 300, 64, "split", seed=1)
    kernels.reset_launch_counts()
    attention(q, k, v)
    assert kernels.launch_counts["flash_attention"] == 1
    attention(q[:, :, :255], k, v)
    attention(q, k, v, bias=torch.zeros((), device=cuda))
    attention(q, k, v, use_kernel=False)
    assert kernels.launch_counts["flash_attention"] == 1


def test_ditvr_routes_through_flash(cuda):
    """A narrow ditvr (256 tokens) launches the kernel once per block and
    agrees with its plain path."""
    gen = torch.Generator().manual_seed(0)
    p = ditvr.init(gen, dim=64, depth=2, adapt_layers=1)
    p16 = _to(p, cuda, torch.bfloat16)
    clip = torch.rand((1, 8, 32, 32, 3), device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = ditvr.apply(p16, clip, degradation_type=2,
                    degradation_scores=(0.1, 0.6, 0.2), heads=2)
    assert kernels.launch_counts["flash_attention"] == 2
    y_p = ditvr.apply(p16, clip, degradation_type=2,
                      degradation_scores=(0.1, 0.6, 0.2), heads=2,
                      kernels=False)
    torch.cuda.synchronize()
    assert (y.float() - y_p.float()).abs().max().item() <= 3e-2


def test_flash_kernel_at_seedvr2_shape(cuda):
    """seedvr2's spatial attention at 180x320: (B*T 8, one head, 3600
    tokens, Dh 128) as views of one (8 * 3600, 384) projection, as the
    UNet's attention block hands them over; 29 query tiles of 128 a
    frame, the last one 16 rows; read in place, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(3600)
    qkv = torch.randn((1, 8 * 3600, 384), generator=gen,
                      device=cuda).bfloat16()
    q, k, v = (z.reshape(8, 1, 3600, 128) for z in qkv.chunk(3, dim=-1))
    assert _flash_plan(8, 1, 3600, 3600, 128, 2, _flash_operands(
        q=q, k=k, v=v, o=q))["copy"] == ()
    before = kernels.launch_counts["flash_attention"]
    got = attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    assert got.shape == (8, 1, 3600, 128)
    assert _rel(got, ref) <= FLASH_TOL[torch.bfloat16]


def test_seedvr2_routes_through_flash(cuda):
    """seedvr2 with the bundled weights on 8 frames of 64x64 (level 2 of
    16x16 = 256 tokens): the flash kernel three times (down level 2, mid,
    up level 2), and the output within a served window's tolerances of the
    plain path fed the same noise."""
    from video_enhancer_tpu_torch.runtime.registry import load_params

    p = _to(load_params("seedvr2"), cuda, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(1)
    clip = torch.rand((1, 8, 64, 64, 3), generator=gen,
                      device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = seedvr2.apply(p, clip)
    counts = dict(kernels.launch_counts)
    y_p = seedvr2.apply(p, clip, kernels=False)
    torch.cuda.synchronize()
    assert counts == {**dict.fromkeys(counts, 0), "flash_attention": 3}
    diff = (y.float() - y_p.float()).abs()
    assert diff.max().item() <= 0.05 and diff.mean().item() <= 0.005


def _to(p, device, dtype):
    if isinstance(p, dict):
        return {k: _to(v, device, dtype) for k, v in p.items()}
    if isinstance(p, list):
        return [_to(v, device, dtype) for v in p]
    return p.to(device=device, dtype=dtype)


# window attention: the kernel keeps the probabilities in fp32, the plain
# form rounds them to the input type before the product with V.
WINDOW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _window_inputs(cuda, dtype, nW, H, N, Dh, layout, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    bias = torch.randn((H, N, N), generator=gen, device=cuda) * 0.5
    if layout == "dense":
        q, k, v = (torch.randn((nW, H, N, Dh), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        return q, k, v, bias
    # rvrt's layout: (nW, H, N, Dh) views of one (nW, N, 3 H Dh) projection;
    # "odd" shifts them by one element, off the 16-byte grid
    off = 1 if layout == "odd" else 0
    qkv = torch.randn((nW, N, 3 * H * Dh + off), generator=gen, device=cuda)
    q, k, v = (t.reshape(nW, N, H, Dh).transpose(1, 2)
               for t in qkv.to(dtype)[..., off:].chunk(3, dim=-1))
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("layout", ["dense", "split", "odd"])
@pytest.mark.parametrize("nW,H,N,Dh", [(37, 4, 128, 16), (5, 3, 100, 24),
                                       (3, 2, 37, 64), (2, 1, 1, 8),
                                       (4, 2, 77, 12), (700, 4, 128, 16)])
def test_window_kernel_matches_plain(cuda, dtype, layout, nW, H, N, Dh):
    q, k, v, bias = _window_inputs(cuda, dtype, nW, H, N, Dh, layout,
                                   seed=nW + N)
    before = kernels.launch_counts["window_attention"]
    got = window_attention(q, k, v, bias)
    ref = window_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention"] == before + 1
    assert got.shape == (nW, H, N, Dh) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= WINDOW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_kernel_scale_bf16_bias_and_large_logits(cuda, dtype):
    """A given scale is used, a bf16 bias is read as fp32, and logits far
    from 0 stay finite."""
    q, k, v, bias = _window_inputs(cuda, dtype, 6, 4, 128, 16, "dense", 3)
    bias = (bias * 20).bfloat16()
    got = window_attention(q * 30, k, v, bias, scale=0.7)
    ref = window_attention_plain(q * 30, k, v, bias, scale=0.7)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= WINDOW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["split", "odd"])
@pytest.mark.parametrize("Dh", [16, 32, 48, 64])
@pytest.mark.parametrize("N", [64, 98, 128])
def test_window_kernel_ring_matches_plain(cuda, dtype, layout, N, Dh):
    """The two-stage ring of the half-type kernel: 301 windows of 4 heads
    (not a multiple of the windows a block, so the last block's run is
    short), views of one qkv projection on the 16-byte grid (cp.async)
    and one element off it (loaded synchronously), N and Dh that pad."""
    nW, H = 301, 4
    assert nW % _window_plan(nW, H, Dh, kernels.sm_count(cuda))["wpb"]
    q, k, v, bias = _window_inputs(cuda, dtype, nW, H, N, Dh, layout,
                                   seed=N + Dh)
    before = kernels.launch_counts["window_attention"]
    got = window_attention(q, k, v, bias)
    ref = window_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention"] == before + 1
    assert got.shape == (nW, H, N, Dh) and torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= WINDOW_TOL[dtype]
    # a kernel that read the bias of another head would fail the check
    assert _rel(window_attention_plain(q, k, v, bias.roll(1, dims=0)),
                ref) > 5 * WINDOW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["split", "odd"])
def test_window_kernel_ring_with_large_logits(cuda, dtype, layout):
    """Logits far from 0 (q x 30, bias x 20) stay finite and agree at
    rvrt's window, through both load paths."""
    q, k, v, bias = _window_inputs(cuda, dtype, 300, 4, 128, 16, layout, 7)
    got = window_attention(q * 30, k, v, bias * 20)
    ref = window_attention_plain(q * 30, k, v, bias * 20)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= WINDOW_TOL[dtype]


@pytest.mark.parametrize("Dh", [8, 16, 24, 32, 48, 64])
def test_window_smem_mirrors_the_kernel(cuda, Dh):
    assert kernels.library().vetk_window_attention_smem(Dh) == \
        _window_plan(100, 4, Dh, 132)["smem"]


def test_window_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn((2, 2, 129, 16), device=cuda)
    with pytest.raises(ValueError, match="N <= 128"):
        window_attention(q, q, q, torch.zeros((2, 129, 129), device=cuda))
    q = torch.randn((2, 2, 8, 80), device=cuda)
    with pytest.raises(ValueError, match="Dh <= 64"):
        window_attention(q, q, q, torch.zeros((2, 8, 8), device=cuda))
    q = torch.randn((2, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="bias must be"):
        window_attention(q, q, q, torch.zeros((8, 8), device=cuda))
    with pytest.raises(TypeError):
        window_attention(q, q.half(), q, torch.zeros((2, 8, 8), device=cuda))


def test_rvrt_routes_through_window_kernel(cuda):
    """A narrow rvrt (dim 32, 2 blocks) launches the kernel once per block
    and agrees with its plain path; a shifted block's windows wrap."""
    gen = torch.Generator().manual_seed(0)
    p16 = _to(rvrt.init(gen, dim=32, depth=2, heads=4), cuda, torch.bfloat16)
    clip = torch.rand((1, 3, 20, 28, 3), device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = rvrt.apply(p16, clip)
    assert kernels.launch_counts["window_attention"] == 2
    y_p = rvrt.apply(p16, clip, kernels=False)
    torch.cuda.synchronize()
    assert y.shape == (1, 3, 80, 112, 3)
    assert (y.float() - y_p.float()).abs().max().item() <= 3e-2


def test_fast_mamba_vsr_routes_through_fused_ssm(cuda):
    """A narrow fast_mamba_vsr (dim 16, 2 layers) launches the fused SSM
    once per layer and agrees with its plain path."""
    gen = torch.Generator().manual_seed(0)
    p16 = _to(fast_mamba_vsr.init(gen, dim=16, num_layers=2), cuda,
              torch.bfloat16)
    clip = torch.rand((1, 16, 12, 20, 3), device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = fast_mamba_vsr.apply(p16, clip)
    assert kernels.launch_counts["fused_bidir_ssm"] == 2
    y_p = fast_mamba_vsr.apply(p16, clip, kernels=False)
    torch.cuda.synchronize()
    assert y.shape == (1, 16, 48, 80, 3)
    assert (y.float() - y_p.float()).abs().max().item() <= 3e-2


# Mamba-1 scans: max |kernel - plain| / max |plain|; both compute in fp32
# from the same stored inputs, the kernel's y rounds once to x's dtype.
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _scan_inputs(cuda, dtype, B, L, D, N, seed, strided=True, offset=3):
    """x, dt, A, B, C, D; with ``strided`` x is a column slice, ``offset``
    columns in, of a wider tensor and B, C column slices of one
    projection, as the layers pass them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    extra = offset if strided else 0
    x = rnd(B, L, D + extra).to(dtype)[..., extra:]
    dt = torch.nn.functional.softplus(rnd(B, L, D, scale=0.5) - 2).to(dtype)
    proj = rnd(B, L, 2 * N + extra).to(dtype)
    Bm, Cm = proj[..., extra:extra + N], proj[..., extra + N:]
    A = -torch.arange(1, N + 1, device=cuda).float() * torch.exp(
        rnd(D, 1, scale=0.3))
    return x, dt, A, Bm, Cm, rnd(D, scale=0.5)


SCAN_SMALL = [(300, 8, 16, 4), (1100, 5, 96, 8), (17, 32, 130, 16),
              (3, 1, 8, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("B,L,D,N", SCAN_SMALL + [(57600, 16, 96, 8)])
def test_scan_short_kernel_matches_plain(cuda, dtype, state, B, L, D, N):
    """Rows 7 (with a nonzero h0: y and h_last) and 8 (no state)."""
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, dtype, B, L, D, N, seed=B + L)
    h0 = torch.randn((B, D, N), device=cuda) if state else None
    key = "selective_scan_short" if state else "selective_scan_short_nostate"
    before = kernels.launch_counts[key]
    y, h = selective_scan_pallas_short(x, dt, A, Bm, Cm, Dv, h0=h0,
                                       need_state=state)
    y_p, h_p = selective_scan_plain(x, dt, A, Bm, Cm, Dv, h0=h0)
    torch.cuda.synchronize()
    assert kernels.launch_counts[key] == before + 1
    assert y.dtype == dtype and y.shape == (B, L, D)
    assert _rel(y, y_p) <= SCAN_TOL[dtype]
    if state:
        assert h.dtype == torch.float32 and h.shape == (B, D, N)
        assert _rel(h, h_p) <= SCAN_TOL[dtype]
        # a kernel that ignored h0 would fail the checks above
        y0, _ = selective_scan_plain(x, dt, A, Bm, Cm, Dv)
        assert _rel(y0, y_p) > 5 * SCAN_TOL[dtype]
    else:
        assert h is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("strided,offset", [(False, 0), (True, 8),
                                            (True, 3)])
@pytest.mark.parametrize("B,L,D,N", [
    (301, 1, 96, 8), (301, 2, 96, 8), (301, 15, 96, 8), (301, 16, 96, 8),
    (301, 17, 96, 8), (301, 31, 96, 8), (301, 32, 96, 8), (301, 33, 96, 8),
    (300, 16, 95, 8), (299, 16, 96, 4), (5, 16, 96, 8)])
def test_scan_short_tile_kernel_matches_plain(cuda, dtype, strided, offset,
                                              B, L, D, N):
    """Row 7 across the tile kernel's L bounds (16, 32; 33 takes the
    walking kernel), B odd against the sequences a block, x dense and a
    column slice 8 columns in (16-byte copies), and at D 95 or 3 columns
    in, where the copies cannot run and the walking kernel takes the
    call; y and h_last from a nonzero h0, and the h0 = 0 control."""
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, dtype, B, L, D, N, seed=B + L,
                                        strided=strided, offset=offset)
    h0 = torch.randn((B, D, N), device=cuda)
    item = x.element_size()
    aligned = offset * item % 16 == 0 and D * item % 16 == 0
    plan = _short_scan_plan(B, L, D, N, item, aligned=offset * item % 16 == 0)
    assert plan["route"] == ("tile" if L <= 32 and aligned else "walk")
    y, h = selective_scan_pallas_short(x, dt, A, Bm, Cm, Dv, h0=h0)
    y_p, h_p = selective_scan_plain(x, dt, A, Bm, Cm, Dv, h0=h0)
    y0, _ = selective_scan_pallas_short(x, dt, A, Bm, Cm, Dv,
                                        h0=torch.zeros_like(h0))
    torch.cuda.synchronize()
    assert _rel(y, y_p) <= SCAN_TOL[dtype]
    assert _rel(h, h_p) <= SCAN_TOL[dtype]
    assert _rel(y0, y_p) > 5 * SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D,N", [(16, 96, 8), (32, 95, 4), (1, 8, 1),
                                   (7, 512, 8)])
def test_scan_short_smem_mirrors_the_kernel(cuda, dtype, L, D, N):
    item = torch.finfo(dtype).bits // 8
    # the plan's sequences a block; three where it walks (D 95)
    seqs = _short_scan_plan(1000, L, D, N, item, aligned=True)["seqs"] or 3
    code = kernels.dtype_code(torch.empty(0, dtype=dtype))
    assert kernels.library().vetk_selective_scan_short_smem(
        code, L, D, N, seqs) == _tile_smem(L, D, N, item, seqs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("strided,offset", [(False, 0), (True, 8),
                                            (True, 3)])
@pytest.mark.parametrize("N", [9, 12, 16])
@pytest.mark.parametrize("L", [1, 7, 16, 32, 33])
@pytest.mark.parametrize("D", [128, 48])
def test_scan_short_n16_kernel_matches_plain(cuda, dtype, strided, offset, N,
                                             L, D):
    """Row 8 at N 9-16 across its tile kernel's L bounds (16, 32; 33 takes
    the walking kernel), B odd against the sequences a block (one at D 128,
    two at D 48), x dense and a column slice 8 columns in (16-byte copies),
    and 3 columns in, where the copies cannot run and the walking kernel
    takes the call; B and C column slices of one projection."""
    B = 301
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + N,
                                        strided=strided, offset=offset)
    aligned = offset * x.element_size() % 16 == 0
    plan = _short_scan_plan(B, L, D, N, x.element_size(), aligned,
                            state=False)
    assert plan["route"] == ("tile_n16" if L <= 32 and aligned else "walk")
    before = kernels.launch_counts["selective_scan_short_nostate"]
    y, h = selective_scan_pallas_short(x, dt, A, Bm, Cm, Dv, need_state=False)
    y_p, _ = selective_scan_plain(x, dt, A, Bm, Cm, Dv)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_short_nostate"] == before + 1
    assert h is None and y.dtype == dtype and y.shape == (B, L, D)
    assert _rel(y, y_p) <= SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_scan_short_n16_kernel_at_the_served_shape(cuda, dtype):
    """Row 8 as ``ssm_apply`` per pixel hands it (57600, 7, 128, N 16): u
    the first half of a 256-wide in_proj output (a column slice at offset
    0), dt dense, B and C slices of one x_proj output after a dt_rank of 8;
    on its tile kernel, one channel a thread."""
    B, L, D, N, rank = 57600, 7, 128, 16, 8
    gen = torch.Generator(device=cuda).manual_seed(8)
    u = torch.randn((B, L, 2 * D), generator=gen, device=cuda).to(dtype)[
        ..., :D]
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, D), generator=gen, device=cuda) * 0.5 - 2).to(dtype)
    proj = torch.randn((B, L, rank + 2 * N), generator=gen,
                       device=cuda).to(dtype)
    Bm, Cm = proj[..., rank:rank + N], proj[..., rank + N:]
    A = -torch.arange(1, N + 1, device=cuda).float() * torch.exp(
        0.3 * torch.randn((D, 1), generator=gen, device=cuda))
    Dv = 0.5 * torch.randn((D,), generator=gen, device=cuda)
    plan = _short_scan_plan(B, L, D, N, u.element_size(),
                            _on_16_byte_grid(u, dt), state=False)
    assert (plan["route"], plan["seqs"]) == ("tile_n16", 1)
    y, _ = selective_scan_pallas_short(u, dt, A, Bm, Cm, Dv, need_state=False)
    y_p, _ = selective_scan_plain(u, dt, A, Bm, Cm, Dv)
    torch.cuda.synchronize()
    assert _rel(y, y_p) <= SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D,N", [(7, 128, 16), (32, 256, 9), (1, 8, 12),
                                   (16, 96, 16)])
def test_scan_short_n16_smem_mirrors_the_kernel(cuda, dtype, L, D, N):
    item = torch.finfo(dtype).bits // 8
    plan = _short_scan_plan(1000, L, D, N, item, True, state=False)
    assert plan["route"] == "tile_n16"
    code = kernels.dtype_code(torch.empty(0, dtype=dtype))
    assert kernels.library().vetk_selective_scan_short_smem(
        code, L, D, N, plan["seqs"]) == _tile_smem(L, D, N, item,
                                                   plan["seqs"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("B,L,D,N", SCAN_SMALL + [(57600, 7, 128, 4)])
def test_scan_bidir_kernel_matches_plain(cuda, dtype, shared, B, L, D, N):
    """Row 6: separate streams, and u / B / C shared by both (the pointers
    alias), as selective_scan_bidir_shared passes them."""
    f = _scan_inputs(cuda, dtype, B, L, D, N, seed=L)
    b = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + 1)
    if shared:
        b = (f[0], b[1], b[2], f[3], f[4], b[5])
    before = kernels.launch_counts["selective_scan_bidir"]
    got = selective_scan_bidir(*f, *b)
    ref = selective_scan_bidir_plain(*f, *b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_bidir"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        assert _rel(g, r) <= SCAN_TOL[dtype]
    if shared:
        y = selective_scan_bidir_shared(f[0], f[1], b[1], f[2], b[2], f[3],
                                        f[4], f[5], b[5])
        assert _rel(y, ref[0] + ref[1]) <= SCAN_TOL[dtype]


def _bidir_streams(cuda, dtype, B, L, D, N, shared, strided=True, offset=3):
    """Both streams of row 6: separate, or with x, B and C of the backward
    stream those of the forward one (dt, A and D its own)."""
    f = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + N, strided=strided,
                     offset=offset)
    b = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + N + 1,
                     strided=strided, offset=offset)
    if shared:
        b = (f[0], b[1], b[2], f[3], f[4], b[5])
    return f, b


def _check_bidir(f, b, dtype):
    before = kernels.launch_counts["selective_scan_bidir"]
    got = selective_scan_bidir(*f, *b)
    ref = selective_scan_bidir_plain(*f, *b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_bidir"] == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel(g, r) <= SCAN_TOL[dtype]
    # a kernel that swapped the directions' outputs would fail the checks
    assert _rel(ref[0], ref[1]) > 5 * SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("N", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("L", [1, 2, 7, 8, 9, 16, 17, 32, 33])
def test_scan_bidir_tile_kernel_matches_plain(cuda, dtype, shared, N, L):
    """Row 6 across the tile kernel's L bounds (8, 16, 32; 33 walks) and N
    bounds (4, 8; 16 walks), streams shared and separate, at D 128 with x
    and dt dense (the tile kernel's copies run) and B and C column slices
    of one projection; B odd against the sequences a block."""
    f, b = _bidir_streams(cuda, dtype, 301, L, 128, N, shared,
                          strided=False)
    plan = _bidir_plan(301, L, 128, N, f[0].element_size(), True, shared)
    assert plan["route"] == ("tile" if L <= 32 and N <= 8 else "walk")
    _check_bidir(f, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("D,offset", [(128, 8), (128, 3), (95, 0), (130, 0),
                                      (96, 8), (8, 0)])
def test_scan_bidir_tile_kernel_layouts_match_plain(cuda, dtype, shared, D,
                                                    offset):
    """Row 6 with x a column slice 8 columns in (16-byte copies in bf16 and
    fp32 alike) or 3 columns in, and D of 95, 130 (rows off the 16-byte
    grid in bf16), 96 and 8: the tile kernel where its copies run, the
    walking kernel elsewhere; L 7, N 4 and 8."""
    for N in (4, 8):
        f, b = _bidir_streams(cuda, dtype, 257, 7, D, N, shared,
                              strided=offset > 0, offset=offset)
        item = f[0].element_size()
        aligned = offset * item % 16 == 0
        plan = _bidir_plan(257, 7, D, N, item, aligned, shared)
        assert plan["route"] == ("tile" if aligned and D * item % 16 == 0
                                 else "walk")
        _check_bidir(f, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("L,D,N", [(7, 128, 4), (32, 96, 8), (1, 8, 1),
                                   (16, 512, 8)])
def test_scan_bidir_smem_mirrors_the_kernel(cuda, dtype, shared, L, D, N):
    item = torch.finfo(dtype).bits // 8
    seqs = _bidir_plan(1000, L, D, N, item, True, shared)["seqs"]
    code = kernels.dtype_code(torch.empty(0, dtype=dtype))
    assert kernels.library().vetk_selective_scan_bidir_smem(
        code, L, D, N, seqs, int(shared)) == _bidir_smem(L, D, N, item, seqs,
                                                         shared)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("B,L,D,N", [(2, 100, 16, 4), (3, 257, 130, 16),
                                     (1, 33, 8, 1), (2, 4099, 64, 16),
                                     (7, 57600, 128, 16)])
def test_scan_long_kernel_matches_plain(cuda, dtype, state, B, L, D, N):
    """Row 9: chunked over L (ragged last chunk), h0 in, h_last out."""
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, dtype, B, L, D, N, seed=L)
    h0 = torch.randn((B, D, N), device=cuda) if state else None
    before = kernels.launch_counts["selective_scan_long"]
    y, h = selective_scan_pallas(x, dt, A, Bm, Cm, Dv, h0=h0)
    y_p, h_p = selective_scan_assoc(x, dt, A, Bm, Cm, Dv, h0=h0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_long"] == before + 1
    assert y.dtype == dtype and h.shape == (B, D, N)
    assert _rel(y, y_p) <= SCAN_TOL[dtype]
    assert _rel(h, h_p) <= SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [True, False])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("B,L,D,N", [
    (2, 33, 95, 1), (3, 1000, 130, 3), (2, 1000, 128, 16), (1, 1000, 95, 9),
    (3, 4099, 130, 16), (1, 777, 128, 6), (2, 57600, 128, 16)])
def test_scan_long_kernel_edges_match_plain(cuda, dtype, state, offset, B, L,
                                            D, N):
    """Row 9: L of one staging round of 32 steps and one more (33), ragged
    last chunks of 128 steps (1000, 4099, 777) and the served 57600; D of 95, 128 and 130 (a
    ragged last block of channels); N of 1, 3, 6, 9 and 16; x, B and C
    dense or column slices 3 columns in; h0 absent and present; y and
    h_last."""
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + N,
                                        strided=offset > 0, offset=offset)
    h0 = torch.randn((B, D, N), device=cuda) if state else None
    before = kernels.launch_counts["selective_scan_long"]
    y, h = selective_scan_pallas(x, dt, A, Bm, Cm, Dv, h0=h0)
    y_p, h_p = selective_scan_assoc(x, dt, A, Bm, Cm, Dv, h0=h0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_long"] == before + 1
    assert y.dtype == dtype and y.shape == (B, L, D)
    assert h.dtype == torch.float32 and h.shape == (B, D, N)
    assert _rel(y, y_p) <= SCAN_TOL[dtype]
    assert _rel(h, h_p) <= SCAN_TOL[dtype]
    if state:
        # the first steps are h0's: a kernel that ignored it would fail
        y0, _ = selective_scan_assoc(x, dt, A, Bm, Cm, Dv)
        assert _rel(y0[:, :8], y_p[:, :8]) > 5 * SCAN_TOL[dtype]


def test_scan_kernels_reject_what_they_do_not_take(cuda):
    x, dt, A, Bm, Cm, Dv = _scan_inputs(cuda, torch.float32, 4, 5, 8, 4, 0)
    with pytest.raises(TypeError, match="share one dtype"):
        selective_scan_pallas_short(x, dt.half(), A, Bm, Cm, Dv)
    x17, dt17, A17, B17, C17, D17 = _scan_inputs(cuda, torch.float32, 4, 5,
                                                 8, 17, 0)
    with pytest.raises(ValueError, match="N <= 16"):
        selective_scan_pallas(x17, dt17, A17, B17, C17, D17)
    with pytest.raises(ValueError, match="h0 must be"):
        selective_scan_pallas_short(x, dt, A, Bm, Cm, Dv,
                                    h0=torch.zeros((4, 8, 4)))
    with pytest.raises(ValueError, match="dense last dim"):
        selective_scan_bidir(x, dt, A, Bm, Cm, Dv, x.transpose(1, 2)
                             .contiguous().transpose(1, 2), dt, A, Bm, Cm, Dv)


def test_selective_scan_dispatch_on_the_card(cuda):
    """JAX's rule: the short kernel for L <= 32 and B >= 1024 (stateless
    with need_state=False), the plain scan for B < 1024, the long kernel
    for L > 32."""
    kernels.reset_launch_counts()
    selective_scan(*_scan_inputs(cuda, torch.bfloat16, 1024, 32, 8, 4, 1))
    selective_scan(*_scan_inputs(cuda, torch.bfloat16, 1024, 8, 8, 4, 1),
                   need_state=False)
    selective_scan(*_scan_inputs(cuda, torch.bfloat16, 1023, 8, 8, 4, 1))
    selective_scan(*_scan_inputs(cuda, torch.bfloat16, 2, 33, 8, 4, 1))
    c = kernels.launch_counts
    assert (c["selective_scan_short"], c["selective_scan_short_nostate"],
            c["selective_scan_long"], c["selective_scan_bidir"]) == (1, 1, 1, 0)


def test_mamba1_layers_route_through_the_scan_kernels(cuda):
    """bimamba per pixel: one bidirectional launch; over long rasters: two
    long-scan launches; ssm_apply per pixel: one stateless launch; bissm
    composed: one bidirectional launch; each against its plain form."""
    gen = torch.Generator().manual_seed(0)
    pb = _to(bimamba_init(gen, 32), cuda, torch.bfloat16)
    pq = _to(bissm_init(gen, 32), cuda, torch.bfloat16)
    pix = torch.randn((1500, 7, 32), device=cuda).bfloat16()
    ras = torch.randn((2, 300, 32), device=cuda).bfloat16()
    cases = [(lambda: bimamba_apply(pb, pix),
              lambda: bimamba_apply(pb, pix, impl="ref"),
              "selective_scan_bidir", 1),
             (lambda: bimamba_apply(pb, ras),
              lambda: bimamba_apply(pb, ras, impl="assoc"),
              "selective_scan_long", 2),
             (lambda: ssm_apply(pb["fwd"], pix),
              lambda: ssm_apply(pb["fwd"], pix, impl="ref"),
              "selective_scan_short_nostate", 1),
             (lambda: bissm_apply(pq, pix, impl="composed"),
              lambda: bissm_apply(pq, pix, impl="plain"),
              "selective_scan_bidir", 1)]
    for run, plain, key, n in cases:
        kernels.reset_launch_counts()
        y = run()
        assert kernels.launch_counts[key] == n
        assert sum(kernels.launch_counts.values()) == n
        assert _rel(y, plain()) <= 3e-2


def test_exact_sharded_fmv_on_one_nccl_rank(cuda):
    """make_exact_sharded_fmv on a one-rank NCCL group: four short-scan
    launches a layer (two directions, two passes each) and no fused SSM,
    within bf16 rounding of the single-device model (fused kernel)."""
    from video_enhancer_tpu_torch.parallel.inference import \
        make_exact_sharded_fmv
    from video_enhancer_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator().manual_seed(0)
    p = fast_mamba_vsr.init(gen, dim=16, num_layers=2)
    p["head"]["w"] = torch.randn(p["head"]["w"].shape, generator=gen) * 0.05
    p["temporal"]["w"] = torch.randn(p["temporal"]["w"].shape,
                                     generator=gen) * 0.05
    p16 = _to(p, cuda, torch.bfloat16)
    clip = torch.rand((1, 8, 32, 40, 3), device=cuda).bfloat16()
    axis = make_mesh(time=1)
    try:
        fn = make_exact_sharded_fmv(axis)
        kernels.reset_launch_counts()
        y = fn(p16, clip)
        torch.cuda.synchronize()
        assert kernels.launch_counts["selective_scan_short"] == 8
        assert sum(kernels.launch_counts.values()) == 8
    finally:
        axis.destroy()
    y1 = fast_mamba_vsr.apply(p16, clip)
    torch.cuda.synchronize()
    assert y.shape == y1.shape == (1, 8, 128, 160, 3)
    assert (y.float() - y1.float()).abs().max().item() <= 3e-2


# Row 10: the shared bidirectional scan (``impl="bmajor"``).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,L,D,N", SCAN_SMALL + [
    (100, 33, 16, 4), (9, 64, 40, 8), (57600, 7, 128, 4),
    (57600, 16, 96, 8)])
def test_scan_bidir_shared_kernel_matches_plain(cuda, dtype, B, L, D, N):
    """One launch against the plain version and against row 6 (which
    computes the same yf + yb): ragged B, L up to the register bound (32)
    and past it (the fp32 workspace), D over one block (130), strided u, B
    and C."""
    u, dtf, Af, Bm, Cm, Df = _scan_inputs(cuda, dtype, B, L, D, N, seed=L)
    _, dtb, Ab, _, _, Db = _scan_inputs(cuda, dtype, B, L, D, N, seed=L + 1)
    args = (u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db)
    before = kernels.launch_counts["selective_scan_bidir_shared"]
    y = selective_scan_bidir_shared(*args, impl="bmajor")
    ref = selective_scan_bidir_shared_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_bidir_shared"] == before + 1
    assert y.dtype == dtype and y.shape == (B, L, D)
    assert _rel(y, ref) <= SCAN_TOL[dtype]
    assert _rel(y, selective_scan_bidir_shared(*args, impl="bidir")) <= \
        SCAN_TOL[dtype]
    # a kernel that dropped the backward direction would fail the check
    yf, _ = selective_scan_plain(u, dtf, Af, Bm, Cm, Df)
    assert _rel(yf, ref) > 5 * SCAN_TOL[dtype]


def _shared_inputs(cuda, dtype, B, L, D, N, rank, seed):
    """Row 10's operands as the composed bissm passes them: u and both dt
    dense, B and C column slices of one x_proj output after ``rank``
    columns of dt; each direction its own A and D."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    u = rnd(B, L, D).to(dtype)
    dtf, dtb = (torch.nn.functional.softplus(rnd(B, L, D, scale=0.5) - 2)
                .to(dtype) for _ in range(2))
    proj = rnd(B, L, rank + 2 * N).to(dtype)
    Bm, Cm = proj[..., rank:rank + N], proj[..., rank + N:]
    Af, Ab = (-torch.arange(1, N + 1, device=cuda).float()
              * torch.exp(rnd(D, 1, scale=0.3)) for _ in range(2))
    return u, dtf, dtb, Af, Ab, Bm, Cm, rnd(D, scale=0.5), rnd(D, scale=0.5)


def _check_shared(args, dtype, route):
    u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db = args
    plan = _shared_scan_plan(*u.shape, Af.shape[1], u.element_size(),
                             _on_16_byte_grid(u, dtf, dtb))
    assert plan["route"] == route
    before = kernels.launch_counts["selective_scan_bidir_shared"]
    y = selective_scan_bidir_shared(*args, impl="bmajor")
    ref = selective_scan_bidir_shared_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["selective_scan_bidir_shared"] == before + 1
    assert y.dtype == dtype and y.shape == u.shape
    assert _rel(y, ref) <= SCAN_TOL[dtype]
    assert _rel(y, selective_scan_bidir_shared(*args, impl="bidir")) <= \
        SCAN_TOL[dtype]
    # a kernel that dropped the backward direction would fail the check
    yf, _ = selective_scan_plain(u, dtf, Af, Bm, Cm, Df)
    assert _rel(yf, ref) > 5 * SCAN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("L", [1, 2, 7, 8, 9, 16, 17, 32, 33])
def test_scan_bidir_sum_kernel_matches_plain(cuda, dtype, N, L):
    """Row 10's tile kernel across its L bounds (8, 16, 32; 33 takes the
    workspace kernel) and N 1-8 at D 128, B odd against the sequences a
    block, B and C slices after a dt_rank of 3; against the plain version
    and row 6 (``impl="bidir"``), with the control."""
    args = _shared_inputs(cuda, dtype, 301, L, 128, N, 3, seed=L + N)
    _check_shared(args, dtype, "tile_sum" if L <= 32 else "workspace")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,L,D,N,rank", [(57600, 7, 128, 4, 4),
                                          (57600, 16, 96, 8, 3)])
def test_scan_bidir_sum_kernel_at_the_served_shapes(cuda, dtype, B, L, D, N,
                                                    rank):
    """Row 10 at vsrm's composed bissm (B and C 4-wide slices after a
    dt_rank of 4) and fast_mamba_vsr's (8-wide after 3): its tile kernel."""
    args = _shared_inputs(cuda, dtype, B, L, D, N, rank, seed=B + L)
    _check_shared(args, dtype, "tile_sum")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D,N", [(7, 128, 4), (16, 96, 8), (1, 8, 1),
                                   (32, 256, 8)])
def test_scan_bidir_shared_smem_mirrors_the_kernel(cuda, dtype, L, D, N):
    item = torch.finfo(dtype).bits // 8
    plan = _shared_scan_plan(1000, L, D, N, item, True)
    assert plan["route"] == "tile_sum"
    code = kernels.dtype_code(torch.empty(0, dtype=dtype))
    assert kernels.library().vetk_selective_scan_bidir_shared_smem(
        code, L, D, N, plan["seqs"]) == _bidir_smem(L, D, N, item,
                                                    plan["seqs"], True, True)


def test_scan_bidir_shared_rejects_what_it_does_not_take(cuda):
    u, dtf, Af, Bm, Cm, Df = _scan_inputs(cuda, torch.float32, 4, 5, 8, 4, 0)
    with pytest.raises(TypeError, match="share one dtype"):
        selective_scan_bidir_shared(u, dtf, dtf.half(), Af, Af, Bm, Cm, Df,
                                    Df, impl="bmajor")
    with pytest.raises(ValueError, match="must be"):
        selective_scan_bidir_shared(u, dtf, dtf, Af, Af[:, :2], Bm, Cm, Df,
                                    Df, impl="bmajor")
    with pytest.raises(ValueError, match="do not match"):
        selective_scan_bidir_shared(u, dtf, dtf[:, :4], Af, Af, Bm, Cm, Df,
                                    Df, impl="bmajor")


# Row 11: the depthwise conv + SiLU.
def _dwconv_inputs(cuda, dtype, B, L, C, K, pad, seed):
    """x as a column slice of a (B, L, C + pad) tensor (offset pad // 2),
    w (C, 1, K) in x's dtype (as bissd casts it), b (C,) fp32."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    off = pad // 2
    x = torch.randn((B, L, C + pad), generator=gen, device=cuda).to(dtype)
    x = x[..., off:off + C]
    w = (torch.randn((C, 1, K), generator=gen, device=cuda)
         / K ** 0.5).to(dtype)
    b = torch.randn((C,), generator=gen, device=cuda) * 0.1
    return x, w, b


DWCONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
              torch.float16: 2e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,L,C,K,pad", [
    (3, 70, 16, 5, 0), (3, 64, 16, 4, 0), (2, 37, 8, 3, 0), (1, 1, 4, 5, 0),
    (2, 50, 24, 8, 0), (2, 45, 6, 1, 0), (2, 33, 7, 2, 3), (2, 100, 12, 6, 1),
    (7, 300, 160, 5, 130), (7, 57600, 160, 5, 130), (7, 57600, 160, 4, 130)])
def test_dwconv_silu_kernel_matches_plain(cuda, dtype, B, L, C, K, pad):
    """K from 1 to 8 (even ones pad asymmetrically), sequences shorter than
    the window and ragged runs, dense rows and rows of vsrm's 290-wide
    in_proj (pad 130: 580 bytes in bf16, 4- not 16-byte aligned) and odd
    strides and widths (every vector width the wrapper picks)."""
    x, w, b = _dwconv_inputs(cuda, dtype, B, L, C, K, pad, seed=L + K)
    before = kernels.launch_counts["dwconv_silu"]
    y = depthwise_conv1d_silu(x, w, b)
    ref = depthwise_conv1d_silu_plain(x, w, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dwconv_silu"] == before + 1
    assert y.dtype == dtype and y.shape == (B, L, C) and y.is_contiguous()
    assert _rel(y, ref) <= DWCONV_TOL[dtype]
    if 1 < K < L:
        # the taps mirrored: a kernel that flips them fails the check
        assert _rel(depthwise_conv1d_silu_plain(x, w.flip(-1), b), ref) > \
            5 * DWCONV_TOL[dtype]


def _dwconv_view(cuda, dtype, B, L, C, K, ld, off, seed):
    """x as columns ``off .. off + C`` of a (B, L, ld) tensor, w in x's
    dtype, b fp32."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, L, ld), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((C, 1, K), generator=gen, device=cuda)
         / K ** 0.5).to(dtype)
    b = torch.randn((C,), generator=gen, device=cuda) * 0.1
    return x[..., off:off + C], w, b


def _check_dwconv(x, w, b):
    dtype, K, L = x.dtype, w.shape[-1], x.shape[1]
    before = kernels.launch_counts["dwconv_silu"]
    y = depthwise_conv1d_silu(x, w, b)
    ref = depthwise_conv1d_silu_plain(x, w, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dwconv_silu"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert _rel(y, ref) <= DWCONV_TOL[dtype]
    if 1 < K < L:
        assert _rel(depthwise_conv1d_silu_plain(x, w.flip(-1), b), ref) > \
            5 * DWCONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("L", [1, 3, 31, 32, 33, 64, 65, 200])
def test_dwconv_silu_tile_edges_match_plain(cuda, dtype, K, L):
    """Row 11 at every K, with L shorter than a tile (64 rows in bf16, 32
    in fp32), exactly one, one row more and ragged tiles, on rows of
    vsrm's 290-wide in_proj output 130 columns in."""
    _check_dwconv(*_dwconv_view(cuda, dtype, 3, L, 160, K, 290, 130,
                                seed=K + L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("off", range(8))
@pytest.mark.parametrize("C,K", [(7, 5), (160, 5), (160, 8), (600, 4),
                                 (96, 3)])
def test_dwconv_silu_every_row_alignment(cuda, dtype, off, C, K):
    """Rows an odd number of elements apart (C + 8 or C + 9), so that they
    start at every offset mod 16 in bf16 and fp16 and every 4-byte one in
    fp32, from every first offset; odd C, C over one slab (600), dense-row
    widths; K 3-8."""
    ld = C + 8 + (C + 1) % 2
    x, w, b = _dwconv_view(cuda, dtype, 2, 150, C, K, ld, off, seed=C + off)
    assert x.stride(1) % 2 == 1
    _check_dwconv(x, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("C,K,L", [(160, 5, 20001), (600, 4, 20001),
                                   (7, 3, 200001), (8, 5, 200001)])
def test_dwconv_silu_walks_many_tiles_a_block(cuda, dtype, C, K, L):
    """More tiles than one wave of blocks, so that each block steps its
    cursor across slabs (C 600), row tiles (a ragged last one) and
    sequences, with the output tile stored by the threads (rows off the
    16-byte grid, or several slabs) and by bulk copies (C 8 in bf16,
    dense 16-byte rows)."""
    x, w, b = _dwconv_view(cuda, dtype, 5, L, C, K, C + 9, 3, seed=C + K)
    plan = _dwconv_plan(5, L, C, K, C + 9, x.element_size(), x.data_ptr(),
                        kernels.sm_count(cuda))
    assert plan["tiles"] > 2 * plan["grid"]
    _check_dwconv(x, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K,ld,off", [(160, 5, 290, 128), (160, 4, 290, 128),
                                        (7, 3, 10, 1), (600, 8, 600, 0),
                                        (4096, 5, 4096, 0), (4, 2, 4, 0)])
def test_dwconv_smem_mirrors_the_kernel(cuda, dtype, C, K, ld, off):
    x = torch.empty((1, 1, ld), dtype=dtype, device=cuda)[..., off:off + C]
    plan = _dwconv_plan(7, 57600, C, K, ld, x.element_size(), x.data_ptr(),
                        kernels.sm_count(cuda))
    code = kernels.dtype_code(x)
    assert kernels.library().vetk_dwconv_silu_smem(
        code, plan["ct"], K, plan["runs"]) == plan["smem"]
    assert plan["smem"] == _dwconv_smem(x.element_size(), plan["ct"], K,
                                        plan["runs"])


def test_dwconv_silu_rejects_what_it_does_not_take(cuda):
    x, w, b = _dwconv_inputs(cuda, torch.float32, 2, 10, 8, 9, 0, 0)
    with pytest.raises(ValueError, match="K <= 8"):
        depthwise_conv1d_silu(x, w, b)
    with pytest.raises(ValueError, match="dense last dim"):
        depthwise_conv1d_silu(x.transpose(1, 2).contiguous().transpose(1, 2),
                              w[..., :5], b)
    with pytest.raises(ValueError, match="must be"):
        depthwise_conv1d_silu(x, w[:4, :, :5], b)


def test_bissd_conv_impl_routes_through_the_conv_kernel(cuda):
    """``bissd_apply(conv_impl="pallas")``: one conv launch beside the two
    SSD launches, within bf16 rounding of the grouped path."""
    gen = torch.Generator().manual_seed(0)
    p = _to(bissd_init(gen, 32, state_dim=16), cuda, torch.bfloat16)
    x = torch.randn((3, 500, 32), device=cuda).bfloat16()
    kernels.reset_launch_counts()
    y = bissd_apply(p, x, conv_impl="pallas")
    torch.cuda.synchronize()
    assert kernels.launch_counts["dwconv_silu"] == 1
    assert kernels.launch_counts["ssd_shared"] == 2
    assert sum(kernels.launch_counts.values()) == 3
    assert _rel(y, bissd_apply(p, x)) <= 3e-2


def _moving_frames(t, h, w, seed):
    """Seeded colour waves moving 2.5 px right and 1.5 px up a frame, with
    fine noise, fp32 in [0, 1], ``(t, h, w, 3)``."""
    import numpy as np

    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = g.uniform(0, 2 * np.pi, 3)
    clip = np.stack([np.stack(
        [0.5 + 0.3 * np.sin(0.15 * (xx - 2.5 * i) + 0.1 * (yy + 1.5 * i)
                            + ph[c]) for c in range(3)], -1)
        for i in range(t)])
    clip = clip + g.normal(0, 0.02, clip.shape)
    return torch.from_numpy(np.clip(clip, 0, 1).astype(np.float32))


@pytest.mark.parametrize("h,w", [(45, 77), (132, 154), (180, 320)])
def test_farneback_on_the_card_matches_cpu(cuda, h, w):
    """The torch Farneback (its fp64 band products, fp32 update and fp64
    solve) on the card against the CPU on the same pair: 1e-4 px."""
    from video_enhancer_tpu_torch.ops.optflow import estimate_flow_farneback

    clip = _moving_frames(2, h, w, seed=h)
    ref = estimate_flow_farneback(clip[0], clip[1])
    got = estimate_flow_farneback(clip[0].to(cuda), clip[1].to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert ref.abs().max() > 1.0
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


def test_temporal_smooth_on_the_card_matches_cpu(cuda):
    """The temporal stage on the card against the CPU on a moving 6-frame
    clip: 1 LSB at most, 0.01 LSB on average."""
    from video_enhancer_tpu_torch.runtime.experts import temporal_smooth

    clip = _moving_frames(6, 64, 96, seed=0)
    ref = temporal_smooth(clip)
    got = temporal_smooth(clip.to(cuda)).cpu()
    lsb = (got - ref).abs() * 255
    assert lsb.max().item() <= 1.0 and lsb.mean().item() <= 0.01
    assert ((ref - clip).abs() * 255).max().item() > 5
