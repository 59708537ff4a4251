"""The launch arithmetic of the port's flash-attention, fused
bidirectional-SSM, SSD and short-scan kernels, on the CPU (no card, no
compiler).

``ops.attention._flash_plan`` and ``ops.scan._fused_bissm_plan`` are the
pure functions the wrappers launch from: padded head width, grid, threads,
shared memory, the TMA maps and the operands to copy (flash); the
instance, warps a block, shared memory and grid (fused SSM). Over the
kernels' whole accepted domains they stay inside what one H100 block and
SM take (232,448 bytes of shared memory a block, 1024 threads, a grid y of
65535, 2048 threads and 64K registers an SM), every TMA stride is a
multiple of 16 bytes or the operand is planned as a copy, and what the
kernels do not take raises the wrappers' ValueErrors. ``_flash_smem`` and
``_fused_smem`` mirror the CUDA sources' own sums; the card-only tests hold
the two against each other.

``ops.ssd._ssd_plan`` picks the SSD's path (tensor cores for bf16 / fp16
at P a multiple of 16 up to 64, H * P <= 128, N <= 16; CUDA cores
otherwise) and the chunks a block walks, so that the blocks fill one wave;
``ops.scan._short_scan_plan`` picks the short scan's kernel (the tile
kernel up to L 32, N 8 and D 512 where x and dt lie on the 16-byte grid;
without state at N 9-16 and D <= 256 its sibling with one channel a
thread; the walking kernel otherwise), its
instance and the sequences a block. ``_ssd_smem`` and ``_tile_smem``
mirror the CUDA sources' sums, held against them on the card.

``ops.attention._window_plan`` is the window kernel's launch (padded head
width, shared memory of the bias and a two-stage ring, blocks an SM and
windows a block); its sum is held against the CUDA source on the card.

``ops.conv._dwconv_plan`` is the depthwise conv + SiLU kernel's launch
(channels a thread, slabs, rows a tile, blocks an SM, one
wave of persistent blocks); ``ops.scan._bidir_plan`` picks the
bidirectional scan's kernel (the tile kernel up to L 32, N 8 and D 512
where both streams' x and dt lie on the 16-byte grid, reading x, B and C
once when the streams share them; the walking kernel otherwise);
``ops.scan._shared_scan_plan`` picks the shared bidirectional scan's
(row 10: the same tile kernel with a summing epilogue where row 6's would
take the streams shared, the register kernel up to L 32 otherwise, the
workspace kernel beyond). ``_dwconv_smem`` and ``_bidir_smem`` mirror the
CUDA sources' sums, held against them on the card.
"""

from __future__ import annotations

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_enhancer_tpu_torch.ops.attention import (_flash_operands,
                                                    _flash_plan, _flash_smem,
                                                    _window_plan)
from video_enhancer_tpu_torch.ops.conv import _dwconv_plan, _dwconv_smem
from video_enhancer_tpu_torch.ops.scan import (_FUSED_INSTANCES, _bidir_plan,
                                               _bidir_smem, _fused_bissm_plan,
                                               _fused_instance, _fused_smem,
                                               _on_16_byte_grid, _same_view,
                                               _shared_scan_plan,
                                               _short_scan_plan, _tile_smem)
from video_enhancer_tpu_torch.ops.ssd import _ssd_plan, _ssd_smem

SMEM_BLOCK = 232448
SMEM_SM = 233472
FAST = settings(max_examples=200, deadline=None, database=None)


def _up(x, m):
    return -(-x // m) * m


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

@st.composite
def _flash_case(draw):
    """A shape in the kernel's domain and each operand as (data_ptr,
    (batch, head, row) strides): base offsets and strides of any size, as
    strided views and padded projections give them."""
    B = draw(st.integers(1, 64))
    H = draw(st.integers(1, 65535 // B))
    Lq = draw(st.integers(1, 1 << 20))
    Lk = draw(st.integers(1, 1 << 20))
    Dh = 16 * draw(st.integers(1, 8))
    item = draw(st.sampled_from([2, 4]))
    ops = {}
    for name, rows in (("q", Lq), ("k", Lk), ("v", Lk), ("o", Lq)):
        ptr = (1 << 20) + item * draw(st.integers(0, 40))
        sl = Dh * draw(st.integers(1, 4)) + draw(st.integers(0, 9))
        sh = draw(st.sampled_from([Dh, sl * rows]))
        sb = max(sl * rows, sh * H) + draw(st.integers(0, 9))
        ops[name] = (ptr, (sb, sh, sl))
    return B, H, Lq, Lk, Dh, item, ops


@FAST
@given(_flash_case())
def test_flash_plan_fits_a_block_over_the_domain(case):
    B, H, Lq, Lk, Dh, item, ops = case
    plan = _flash_plan(B, H, Lq, Lk, Dh, item, ops)
    assert plan["smem"] <= SMEM_BLOCK
    assert plan["threads"] <= 1024
    assert plan["grid"][1] == B * H <= 65535
    assert plan["dhp"] in ((32, 64, 128) if item == 4 else (64, 128))
    assert Dh <= plan["dhp"]
    if item == 4:           # CUDA-core kernel: 64 query rows a block, no TMA
        assert plan["grid"][0] == _up(Lq, 64) // 64 and plan["copy"] == ()
        return
    assert plan["grid"][0] == _up(Lq, 128) // 128
    for name, t in plan["tma"].items():
        ptr = ops[name][0]
        aligned = ptr % 16 == 0 and all(s % 16 == 0 for s in t["stride_bytes"])
        assert (name in plan["copy"]) == (not aligned)
        order = [(t["perm"] >> (2 * pos)) & 3 for pos in range(3)]
        assert sorted(order) == [0, 1, 2]
        # the map's dims 1-3 in stride order, the box a 64-column chunk of
        # 128 rows (64 for the output)
        assert list(t["stride_bytes"]) == sorted(t["stride_bytes"])
        assert t["dims"][0] == Dh and t["box"][0] == 64
        rows = {"q": Lq, "k": Lk, "v": Lk, "o": Lq}[name]
        assert sorted(t["dims"][1:]) == sorted((rows, H, B))
        assert sorted(t["box"][1:]) == [1, 1, 64 if name == "o" else 128]


@FAST
@given(_flash_case())
def test_flash_plan_after_the_copy_needs_none(case):
    """What the wrapper copies comes out dense and aligned: planning again
    on the copies asks for no copy."""
    B, H, Lq, Lk, Dh, item, ops = case
    plan = _flash_plan(B, H, Lq, Lk, Dh, item, ops)
    rows = {"q": Lq, "k": Lk, "v": Lk, "o": Lq}
    dense = {n: (1 << 20, (H * rows[n] * Dh, rows[n] * Dh, Dh))
             if n in plan["copy"] else ops[n] for n in ops}
    assert _flash_plan(B, H, Lq, Lk, Dh, item, dense)["copy"] == ()


@pytest.mark.parametrize("Dh", [0, 8, 24, 100, 144, 256])
def test_flash_plan_refuses_a_head_dim(Dh):
    ops = {n: (0, (1, 1, 1)) for n in "qkvo"}
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        _flash_plan(1, 1, 8, 8, Dh, 2, ops)


@pytest.mark.parametrize("B,H,Lq,Lk", [(1, 1, 0, 8), (1, 1, 8, 0),
                                       (256, 257, 8, 8), (65536, 1, 8, 8)])
def test_flash_plan_refuses_lengths_and_rows(B, H, Lq, Lk):
    ops = {n: (0, (1, 1, 1)) for n in "qkvo"}
    with pytest.raises(ValueError, match=r"Lq, Lk >= 1 and B\*H <= 65535"):
        _flash_plan(B, H, Lq, Lk, 64, 2, ops)


def _split_views(B, H, L, Dh, dtype, offset=0):
    """q, k, v as ditvr hands them over: (B, H, L, Dh) views of the column
    slices of one (B, L, 3*H*Dh) projection, shifted by ``offset``
    elements; o as the wrapper allocates it."""
    qkv = torch.zeros((B, L, 3 * H * Dh + offset), dtype=dtype)[..., offset:]
    q, k, v = (z.reshape(B, L, H, Dh).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    o = torch.empty((B, L, H, Dh), dtype=dtype).permute(0, 2, 1, 3)
    return q, k, v, o


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_copy_rule_reads_ditvr_views_in_place(dtype):
    B, H, L, Dh = 2, 3, 256, 128       # ditvr's B, heads and head dim
    q, k, v, o = _split_views(B, H, L, Dh, dtype)
    plan = _flash_plan(B, H, L, L, Dh, 2, _flash_operands(q=q, k=k, v=v, o=o))
    assert plan["copy"] == ()
    # row stride 3*H*Dh = 1152 elements, heads Dh apart: heads are the
    # map's inner dimension
    assert plan["tma"]["q"]["stride_bytes"] == (256, 2304, 2304 * L)
    assert plan["tma"]["q"]["box"] == (64, 1, 128, 1)
    assert plan["strides"]["q"] == (1152 * L, 128, 1152)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_copy_rule_copies_an_odd_offset_view(dtype):
    B, H, L, Dh = 2, 3, 256, 128
    q, k, v, o = _split_views(B, H, L, Dh, dtype, offset=1)
    ops = _flash_operands(q=q, k=k, v=v, o=o)
    assert all(ops[n][0] % 16 for n in "qkv")
    plan = _flash_plan(B, H, L, L, Dh, 2, ops)
    assert plan["copy"] == ("q", "k", "v")
    copies = {n: t.clone(memory_format=torch.contiguous_format)
              for n, t in (("q", q), ("k", k), ("v", v))}
    again = _flash_plan(B, H, L, L, Dh, 2, _flash_operands(**copies, o=o))
    assert again["copy"] == ()


def test_flash_copy_rule_copies_a_misaligned_row_of_one():
    """A single misaligned row is dense already; the copy the plan asks for
    must still move it (``contiguous`` would return the same view)."""
    x = torch.zeros((1, 1, 1, 49), dtype=torch.bfloat16)[..., 1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    plan = _flash_plan(1, 1, 1, 1, 48, 2, _flash_operands(q=x, k=x, v=x, o=x))
    assert plan["copy"] == ("q", "k", "v", "o")
    y = x.clone(memory_format=torch.contiguous_format)
    assert _flash_plan(1, 1, 1, 1, 48, 2,
                       _flash_operands(q=y, k=y, v=y, o=y))["copy"] == ()


def test_flash_copy_rule_ignores_the_stride_of_a_dim_of_one():
    """A batch of one may carry any batch stride: it is never stepped."""
    q = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16)
    odd = q.as_strided((1, 2, 40, 64), (7, 40 * 64, 64, 1))
    ops = _flash_operands(q=odd, k=q, v=q, o=q)
    assert _flash_plan(1, 2, 40, 40, 64, 2, ops)["copy"] == ()


def test_flash_smem_is_the_kernels():
    """Three stages of K and V tiles plus the Q tile and ten barriers, and
    1 KB to align the base: 225 KB at Dh 128."""
    assert _flash_smem(128, 2) == 32768 + 3 * 65536 + 80 + 1024
    assert _flash_smem(64, 2) == 16384 + 3 * 32768 + 80 + 1024
    assert _flash_smem(128, 4) == 4 * (128 * 64 + 128 * 68 + 64 * 128)


# --------------------------------------------------------------------------
# fused bidirectional SSM
# --------------------------------------------------------------------------

_fused_domain = dict(B=st.integers(1, 1 << 20), L=st.integers(1, 32),
                     D=st.integers(1, 256), N=st.integers(1, 16),
                     K=st.integers(1, 8), r=st.integers(1, 16),
                     item=st.sampled_from([2, 4]),
                     sms=st.sampled_from([1, 114, 132]),
                     regs=st.one_of(st.none(), st.integers(24, 255)))


@FAST
@given(**_fused_domain)
def test_fused_plan_fits_an_sm_over_the_domain(B, L, D, N, K, r, item, sms,
                                               regs):
    plan = _fused_bissm_plan(B, L, D, N, K, r, item, sms, regs)
    name, n, k, rank, cpl, lmax = _FUSED_INSTANCES[plan["index"]]
    assert plan["instance"] == name
    assert N <= n and K <= k and r <= rank and D <= 32 * cpl and L <= lmax
    w, per_sm = plan["warps"], plan["blocks_per_sm"]
    assert plan["threads"] == 32 * w <= (128 if name == "generic" else 512)
    assert plan["smem"] <= SMEM_BLOCK
    assert per_sm >= 1 and per_sm * (plan["smem"] + 1024) <= SMEM_SM
    assert per_sm * 32 * w <= 2048
    if regs:
        assert per_sm * w * 32 * _up(regs, 8) <= 65536
    # one wave at most; every warp has a sequence when B allows it
    assert 1 <= plan["grid"] <= per_sm * sms
    assert plan["grid"] <= _up(B, w) // w


@pytest.mark.parametrize("shape,instance", [
    ((57600, 7, 128, 4, 5, 4), "vsrm"),
    ((57600, 16, 96, 8, 5, 3), "fast_mamba_vsr"),
    ((57600, 9, 128, 4, 5, 4), "generic"),      # past vsrm's bound on L
    ((57600, 7, 64, 4, 5, 4), "generic"),       # another channels a lane
    ((57600, 16, 96, 8, 4, 3), "generic"),
    ((3, 32, 256, 16, 8, 16), "generic")])
def test_fused_plan_picks_the_instance(shape, instance):
    plan = _fused_bissm_plan(*shape, 2, 132, 128)
    assert plan["instance"] == instance


def test_fused_plan_at_the_served_shapes():
    """vsrm and fast_mamba_vsr at 128 registers a thread: 16 and 15 warps
    a block, one block an SM, a grid of one wave."""
    vsrm = _fused_bissm_plan(57600, 7, 128, 4, 5, 4, 2, 132, 128)
    fmv = _fused_bissm_plan(57600, 16, 96, 8, 5, 3, 2, 132, 128)
    assert (vsrm["warps"], vsrm["blocks_per_sm"], vsrm["grid"]) == (16, 1, 132)
    assert (fmv["warps"], fmv["blocks_per_sm"], fmv["grid"]) == (15, 1, 132)


def test_fused_smem_is_the_kernels():
    """The weights staged in fp32 (wx^T rows padded to an odd number of
    float4s, A_f, A_b, wdt and five vectors; the generic instance also its
    conv taps), then per warp the u and gate tiles, the fp32 x stash and
    the projections (dt | B | C, each padded to 4)."""
    # vsrm, bf16, L 7, D 128: 29 rows; 2 tiles of 1792, x 3584, proj 336
    assert _fused_smem(0, 7, 128, 2, 16) == 29 * 512 + 16 * (2 * 1792 + 3584 + 336)
    # fast_mamba_vsr, bf16, L 16, D 96: wx^T 20 + 16 + 3 + 5 rows
    assert _fused_smem(1, 16, 96, 2, 15) == 44 * 384 + 15 * (2 * 3072 + 6144 + 1280)
    # generic, fp32, L 32, D 256: wx^T 52 + 32 + 16 + 5 + K 8 rows
    assert _fused_smem(2, 32, 256, 4, 1) == 113 * 1024 + (2 * 32768 + 32768 + 6144)


@pytest.mark.parametrize("L,D,N,K,r", [(33, 128, 4, 5, 4), (7, 257, 4, 5, 4),
                                       (7, 128, 17, 5, 4), (7, 128, 4, 9, 4),
                                       (7, 128, 4, 5, 17)])
def test_fused_plan_refuses_past_the_bounds(L, D, N, K, r):
    msg = (r"kernel takes L <= 32, D <= 256, N <= 16, K <= 8, "
           r"dt_rank <= 16")
    with pytest.raises(ValueError, match=msg):
        _fused_bissm_plan(100, L, D, N, K, r, 2, 132)
    with pytest.raises(ValueError, match=msg):
        _fused_instance(N, K, r, D, L)


# --------------------------------------------------------------------------
# SSD chunked scan (rows 1-2)
# --------------------------------------------------------------------------

_HALF = (torch.bfloat16, torch.float16)
_ssd_domain = dict(b=st.integers(1, 1 << 20), L=st.integers(1, 1 << 22),
                   H=st.integers(1, 8), P=st.integers(1, 64),
                   N=st.integers(1, 128),
                   dtype=st.sampled_from([torch.bfloat16, torch.float16,
                                          torch.float32]),
                   sms=st.sampled_from([1, 114, 132]))


@FAST
@given(**_ssd_domain)
def test_ssd_plan_fills_one_wave_over_the_domain(b, L, H, P, N, dtype, sms):
    """The batch lies on gridDim.x, so any b is taken (past 65,535 too); the
    CUDA-core path's chunks lie on y and are refused past 65,535."""
    K = -(-L // 64)
    mma = (dtype in _HALF and P % 16 == 0 and H * P <= 128 and N <= 16)
    if not mma and K > 65535:
        with pytest.raises(ValueError, match="at most 65535 chunks"):
            _ssd_plan(b, L, H, P, N, dtype, sms)
        return
    plan = _ssd_plan(b, L, H, P, N, dtype, sms)
    assert plan["chunks"] == K and plan["chunk"] == 64
    assert plan["route"] == ("mma" if mma else "simt")
    if not mma:
        assert (plan["run"], plan["runs"]) == (1, K)
        assert plan["grid"] == (b, K, H) and plan["smem"] <= SMEM_BLOCK
        return
    R, M, per_sm = plan["run"], plan["runs"], plan["blocks_per_sm"]
    assert 1 <= R <= K and M == -(-K // R) and plan["grid"] == (b, M)
    assert M <= 65535
    assert plan["threads"] == 128 and plan["smem"] == _ssd_smem(H, P)
    assert per_sm >= 1 and per_sm * (plan["smem"] + 1024) <= SMEM_SM
    slots = per_sm * sms
    if b <= slots:
        # one wave, and no shorter run would give one
        assert b * M <= slots
        assert R == 1 or b * -(-K // (R - 1)) > slots
    else:
        assert R == K


def test_ssd_plan_at_the_served_shape():
    """vsrm's spatial SSD (b 7, L 57600, H 2, P 64, N 16) in bf16: runs of
    17 of the 900 chunks, 53 runs a frame, 371 blocks in one wave of three
    an SM; fp32 keeps the CUDA-core path, a block per chunk and head.
    fast_mamba_vsr_ssd's temporal SSD (a sequence per pixel: 57,600 at
    180x320, 368,640 for a group of two 360x512 tiles; L 16, H 2, P 48, N
    8) takes the tensor-core path, one block per sequence walking one
    partial chunk."""
    plan = _ssd_plan(7, 57600, 2, 64, 16, torch.bfloat16, 132)
    assert plan["route"] == "mma" and plan["smem"] == 74768
    assert (plan["run"], plan["runs"], plan["grid"]) == (17, 53, (7, 53))
    assert plan["blocks_per_sm"] == 3 and 7 * 53 <= 3 * 132
    f32 = _ssd_plan(7, 57600, 2, 64, 16, torch.float32, 132)
    assert (f32["route"], f32["grid"]) == ("simt", (7, 900, 2))
    for b in (57600, 368640):
        fmv = _ssd_plan(b, 16, 2, 48, 8, torch.bfloat16, 132)
        assert fmv["route"] == "mma" and fmv["chunks"] == 1
        assert (fmv["run"], fmv["runs"], fmv["grid"]) == (1, 1, (b, 1))


def test_ssd_smem_is_the_kernels():
    """Two stages of x (64 rows of H*P + 8), B and C (64 rows of 24) and
    dt (64 x H fp32); B o e^(G-g) and C o e^g per head; the entering state
    (16 rows of P + 8) per head and 16 rows of y for each of four warps;
    the log decays (64 H + 2 H floats), rounded up to 16 bytes."""
    stage = 64 * 136 * 2 + 2 * 64 * 24 * 2 + 64 * 2 * 4
    assert _ssd_smem(2, 64) == (2 * stage + 2 * 2 * 64 * 24 * 2
                                + 6 * 16 * 72 * 2 + 132 * 4)
    stage = 64 * 40 * 2 + 2 * 64 * 24 * 2 + 64 * 4
    assert _ssd_smem(1, 32) == -(-(2 * stage + 2 * 64 * 24 * 2 + 5 * 16 * 40 * 2
                                   + 66 * 4) // 16) * 16


@pytest.mark.parametrize("shape,route", [
    ((2, 300, 2, 64, 16, torch.bfloat16), "mma"),
    ((1, 64, 1, 32, 8, torch.float16), "mma"),
    ((3, 1, 2, 16, 4, torch.bfloat16), "mma"),
    ((2, 1000, 4, 48, 32, torch.bfloat16), "simt"),   # N > 16, H * P > 128
    ((2, 1000, 2, 40, 16, torch.bfloat16), "simt"),   # P not a multiple of 16
    ((7, 57600, 2, 64, 16, torch.float32), "simt")])
def test_ssd_plan_picks_the_route(shape, route):
    assert _ssd_plan(*shape, 132)["route"] == route


@pytest.mark.parametrize("b,L,H,P,N", [(1, 64, 1, 65, 16), (1, 64, 1, 64, 129),
                                       (1 << 25, 64, 1, 64, 128),
                                       (1, 0, 1, 64, 16)])
def test_ssd_plan_refuses_past_the_bounds(b, L, H, P, N):
    """Past P 64 or N 128, a state pass of 2^31 blocks, L 0; and on the
    CUDA-core path more than 65,535 chunks (fp32 at L 64 * 65,535 + 1)."""
    with pytest.raises(ValueError, match="kernel takes P <= 64"):
        _ssd_plan(b, L, H, P, N, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="at most 65535 chunks"):
        _ssd_plan(1, 64 * 65535 + 1, 2, 64, 16, torch.float32, 132)


# --------------------------------------------------------------------------
# short scan with and without state (rows 7-8)
# --------------------------------------------------------------------------

_short_domain = dict(B=st.integers(1, 1 << 20), L=st.integers(1, 64),
                     D=st.integers(1, 1024), N=st.integers(1, 16),
                     item=st.sampled_from([2, 4]), aligned=st.booleans())


@FAST
@given(**_short_domain)
def test_short_scan_plan_fits_a_block_over_the_domain(B, L, D, N, item,
                                                      aligned):
    plan = _short_scan_plan(B, L, D, N, item, aligned)
    tps = -(-D // 2)
    if plan["route"] == "walk":
        assert plan["seqs"] == 0
        assert (L > 32 or N > 8 or tps > 256 or not aligned
                or D * item % 16 or _tile_smem(L, D, N, item, 1) > SMEM_BLOCK)
        assert plan["threads"] <= 256 and plan["grid"][0] == B
        assert plan["grid"][1] * plan["threads"] >= D
        return
    seqs = plan["seqs"]
    assert L <= 32 and N <= 8 and 1 <= seqs <= B
    assert aligned and D * item % 16 == 0
    assert plan["threads"] == seqs * tps <= 256
    assert plan["lmax"] == (16 if L <= 16 else 32) and L <= plan["lmax"]
    assert plan["nmax"] == (4 if N <= 4 else 8) and N <= plan["nmax"]
    assert plan["smem"] == _tile_smem(L, D, N, item, seqs) <= SMEM_BLOCK
    assert plan["grid"] == (-(-B // seqs),)


def test_short_scan_plan_at_the_served_shapes():
    """Row 7 at the sharded fast_mamba_vsr's (57600, 16, 96, 8): the tile
    kernel, two sequences (96 threads, three full warps) a block; row 8 at
    the per-pixel (57600, 7, 128, 16) takes its tile kernel with one channel
    a thread, a sequence (128 threads) a group, two stages of x and dt
    tiles and B and C chunks (80 bytes a row each) and B and C 32 wide as
    fp32, eight blocks an SM by their 64 registers, one wave of 1056
    persistent blocks on 132 SMs; row 7 at N 16 keeps the walking
    kernel."""
    fmv = _short_scan_plan(57600, 16, 96, 8, 2, True)
    assert (fmv["route"], fmv["seqs"], fmv["threads"], fmv["grid"]) == (
        "tile", 2, 96, (28800,))
    assert (fmv["lmax"], fmv["nmax"], fmv["smem"]) == (16, 8, 14336)
    pix = _short_scan_plan(57600, 7, 128, 16, 2, True, state=False)
    assert (pix["route"], pix["seqs"], pix["threads"], pix["grid"]) == (
        "tile_n16", 1, 128, (1056,))
    assert (pix["lmax"], pix["nmax"], pix["smem"]) == (16, 16, 10304)
    assert 10304 == 2 * 7 * (2 * 128 * 2 + 2 * 80) + 7 * 32 * 4
    assert pix["blocks_per_sm"] == 8
    with_state = _short_scan_plan(57600, 7, 128, 16, 2, True)
    assert (with_state["route"], with_state["grid"],
            with_state["threads"]) == ("walk", (57600, 1), 128)


_nostate_domain = dict(B=st.integers(1, 1 << 20), L=st.integers(1, 33),
                       D=st.integers(1, 1024), N=st.integers(1, 16),
                       item=st.sampled_from([2, 4]), aligned=st.booleans())


@FAST
@given(**_nostate_domain)
def test_nostate_scan_plan_fits_a_block_over_the_domain(B, L, D, N, item,
                                                        aligned):
    """Row 8: every tile route stays within 256 threads and a block's
    shared memory; N 9-16 takes the kernel with one channel a thread (D
    threads a sequence), N <= 8 the one with two, each with the fewest
    sequences that fill whole warps; the walking kernel only where no tile
    route can run."""
    plan = _short_scan_plan(B, L, D, N, item, aligned, state=False)
    tps = D if N > 8 else -(-D // 2)
    if plan["route"] == "walk":
        assert plan["seqs"] == 0
        assert (L > 32 or tps > 256 or not aligned or D * item % 16
                or _tile_smem(L, D, N, item, 1) > SMEM_BLOCK)
        return
    assert plan["route"] == ("tile_n16" if N > 8 else "tile")
    seqs = plan["seqs"]
    assert L <= 32 and aligned and D * item % 16 == 0 and 1 <= seqs <= B
    assert plan["threads"] == seqs * tps <= 256
    assert plan["nmax"] == (4 if N <= 4 else 8 if N <= 8 else 16)
    assert N <= plan["nmax"] and L <= plan["lmax"]
    assert plan["smem"] == _tile_smem(L, D, N, item, seqs) <= SMEM_BLOCK
    if N > 8:
        # one wave of persistent blocks that fit an SM at 64 registers
        per_sm = plan["blocks_per_sm"]
        warps = -(-plan["threads"] // 32)
        assert per_sm >= 1 and per_sm * warps * 32 * 64 <= 65536
        assert per_sm * warps <= 64 and per_sm * (plan["smem"] + 1024) <= SMEM_SM
        assert plan["grid"] == (min(-(-B // seqs), per_sm * 132),)
    else:
        assert plan["grid"] == (-(-B // seqs),)
    if seqs * tps % 32 == 0:
        # the fewest whole-warp sequences a block
        assert not [c for c in range(1, seqs) if c * tps % 32 == 0]


@pytest.mark.parametrize("L,D,N,item,aligned,route", [
    (7, 128, 16, 2, True, "tile_n16"), (7, 128, 9, 2, True, "tile_n16"),
    (32, 128, 12, 4, True, "tile_n16"), (1, 8, 16, 2, True, "tile_n16"),
    (7, 256, 16, 2, True, "tile_n16"), (33, 128, 16, 2, True, "walk"),
    (7, 128, 16, 2, False, "walk"), (7, 130, 16, 2, True, "walk"),
    (7, 264, 16, 2, True, "walk"), (7, 128, 8, 2, True, "tile")])
def test_nostate_scan_plan_picks_the_kernel(L, D, N, item, aligned, route):
    """Row 8: its tile kernel with one channel a thread at N 9-16 up to L
    32 and D 256 where x and dt lie on the 16-byte grid (x off it, e.g. a
    slice 3 columns in, walks); L 33 walks; N <= 8 keeps the kernel with
    two channels a thread."""
    plan = _short_scan_plan(1000, L, D, N, item, aligned, state=False)
    assert plan["route"] == route
    if route == "tile_n16":
        assert plan["lmax"] == (16 if L <= 16 else 32)
        assert plan["nmax"] == 16


def test_nostate_scan_plan_refuses_n_17():
    with pytest.raises(ValueError, match="kernel takes N <= 16"):
        _short_scan_plan(57600, 7, 128, 17, 2, True, state=False)


@pytest.mark.parametrize("L,D,N,route", [
    (1, 8, 1, "tile"), (16, 96, 8, "tile"), (17, 96, 8, "tile"),
    (32, 88, 8, "tile"), (33, 96, 8, "walk"), (16, 96, 9, "walk"),
    (16, 512, 8, "tile"), (16, 520, 8, "walk")])
def test_short_scan_plan_picks_the_kernel(L, D, N, route):
    assert _short_scan_plan(1000, L, D, N, 2, True)["route"] == route


@pytest.mark.parametrize("D,item,aligned,route", [
    (96, 2, True, "tile"), (95, 2, True, "walk"), (92, 2, True, "walk"),
    (92, 4, True, "tile"), (95, 4, True, "walk"), (96, 2, False, "walk"),
    (96, 4, False, "walk")])
def test_short_scan_plan_takes_the_tile_kernel_only_where_it_copies(
        D, item, aligned, route):
    """The tile kernel reads x and dt by 16-byte copies only; D not a
    multiple of 16 bytes, or operands off the 16-byte grid, walk."""
    assert _short_scan_plan(57600, 16, D, 8, item, aligned)["route"] == route


@pytest.mark.parametrize("B,L,D,N", [(10, 8, 16, 17), (0, 8, 16, 4),
                                     (10, 0, 16, 4), (10, 8, 0, 4)])
def test_short_scan_plan_refuses_past_the_bounds(B, L, D, N):
    with pytest.raises(ValueError, match="kernel takes N <= 16"):
        _short_scan_plan(B, L, D, N, 2, True)


# --------------------------------------------------------------------------
# window attention (row 5)
# --------------------------------------------------------------------------

@FAST
@given(nW=st.integers(1, 1 << 20), H=st.integers(1, 65535),
       Dh=st.integers(1, 64), sms=st.sampled_from([1, 114, 132]))
def test_window_plan_fits_an_sm_over_the_domain(nW, H, Dh, sms):
    """The bias and the two-stage ring fit the blocks an SM the plan
    counts on (two at Dh <= 16), the grid covers every window of every
    head, and with a window a block or more of work a block the blocks
    make one wave."""
    plan = _window_plan(nW, H, Dh, sms)
    dp, per_sm, wpb = plan["dp"], plan["blocks_per_sm"], plan["wpb"]
    assert dp in (16, 32, 64) and Dh <= dp and (dp == 16 or dp // 2 < Dh)
    assert plan["smem"] == 128 * 128 * 4 + 2 * 3 * 128 * (dp + 8) * 2
    assert plan["smem"] <= SMEM_BLOCK
    assert per_sm == (2 if dp == 16 else 1)
    assert per_sm * (plan["smem"] + 1024) <= SMEM_SM
    gx, gy = plan["grid"]
    assert gy == H and (gx - 1) * wpb < nW <= gx * wpb
    if nW * H >= per_sm * sms:
        assert gx * gy <= per_sm * sms + H


def test_window_plan_at_rvrt_shape():
    """rvrt at 180x320 (nW 3680, H 4, Dh 16): 56 windows a block, 66 x 4
    blocks, two an SM of 102,400 bytes each (64 KB of bias, 2 x 18 KB of
    ring)."""
    plan = _window_plan(3680, 4, 16, 132)
    assert (plan["dp"], plan["wpb"], plan["grid"]) == (16, 56, (66, 4))
    assert (plan["smem"], plan["blocks_per_sm"]) == (102400, 2)


# --------------------------------------------------------------------------
# depthwise conv + SiLU (row 11)
# --------------------------------------------------------------------------

@FAST
@given(B=st.integers(1, 64), L=st.integers(1, 1 << 20),
       C=st.integers(1, 8192), K=st.integers(1, 8), pad=st.integers(0, 40),
       item=st.sampled_from([2, 4]), ptr=st.integers(0, 15),
       sms=st.sampled_from([1, 114, 132]))
def test_dwconv_plan_fits_an_sm_over_the_domain(B, L, C, K, pad, item, ptr,
                                                sms):
    """The slabs cover C with at most 256 threads a row, the tile's threads
    fit a block of 320, the ring and the output tile fit the blocks an SM
    the plan counts on, and the blocks make one wave over the tiles."""
    ld = C + pad
    ptr -= ptr % item
    plan = _dwconv_plan(B, L, C, K, ld, item, ptr, sms)
    vec, ct, runs = plan["vec"], plan["ct"], plan["runs"]
    assert vec == (2 if item == 2 and C % 2 == 0 and ld % 2 == 0
                   and ptr % 4 == 0 else 1)
    assert ct % vec == 0 and ct <= C and ct // vec <= 256
    assert (plan["slabs"] - 1) * ct < C <= plan["slabs"] * ct
    assert 1 <= runs <= 16 and plan["rows"] == 16 * runs
    assert plan["threads"] == ct // vec * runs <= 320
    assert plan["kt"] == (K if K in (4, 5) else 8)
    assert plan["smem"] == _dwconv_smem(item, ct, K, runs)
    assert plan["smem"] <= SMEM_BLOCK
    per_sm = plan["blocks_per_sm"]
    assert per_sm >= 1 and per_sm * (plan["smem"] + 1024) <= SMEM_SM
    assert per_sm * plan["threads"] <= 2048
    assert plan["tiles"] == B * _up(L, plan["rows"]) // plan["rows"] * \
        plan["slabs"]
    assert 1 <= plan["grid"] == min(plan["tiles"], per_sm * sms)


def test_dwconv_plan_at_the_served_shape():
    """vsrm's (7, 57600, 160) slice of its 290-wide in_proj output, 128
    columns in, K 5: bf16 takes two channels a thread, tiles of 64 rows
    (320 threads, ten whole warps), three stages of 68 staged rows of 336
    bytes and two 64-row output tiles (111,552 bytes), two blocks an SM,
    264 blocks over 6,300 tiles; fp32 one channel a thread and 32-row
    tiles."""
    bf16 = _dwconv_plan(7, 57600, 160, 5, 290, 2, 1 << 20 | 256, 132)
    assert (bf16["vec"], bf16["ct"], bf16["slabs"], bf16["runs"],
            bf16["rows"], bf16["threads"]) == (2, 160, 1, 4, 64, 320)
    assert (bf16["smem"], bf16["blocks_per_sm"]) == (111552, 2)
    assert (bf16["tiles"], bf16["grid"]) == (6300, 264)
    assert (3 * 68 + 2 * 64) * 336 == 111552
    f32 = _dwconv_plan(7, 57600, 160, 5, 290, 4, 1 << 20 | 512, 132)
    assert (f32["vec"], f32["runs"], f32["rows"], f32["threads"]) == (
        1, 2, 32, 320)
    assert (f32["smem"], f32["grid"]) == ((3 * 36 + 2 * 32) * 656, 264)


@pytest.mark.parametrize("item,C,ld,ptr,vec", [
    (2, 160, 290, 256, 2),     # vsrm's rows: 580 bytes apart, on 4 bytes
    (2, 160, 290, 260, 2),     # 130 columns in
    (2, 160, 290, 258, 1),     # x on 2 bytes
    (2, 160, 291, 256, 1),     # an odd row stride
    (2, 7, 10, 2, 1),          # an odd C
    (2, 160, 160, 0, 2),       # dense rows
    (4, 160, 290, 256, 1)])    # fp32: one channel a thread
def test_dwconv_plan_picks_the_vector_width(item, C, ld, ptr, vec):
    assert _dwconv_plan(7, 1000, C, 5, ld, item, ptr, 132)["vec"] == vec


@pytest.mark.parametrize("C,item,slabs,ct", [(512, 2, 1, 512),
                                             (514, 2, 2, 258),
                                             (600, 4, 3, 200),
                                             (4096, 4, 16, 256)])
def test_dwconv_plan_splits_wide_rows_into_even_slabs(C, item, slabs, ct):
    plan = _dwconv_plan(2, 1000, C, 5, C, item, 0, 132)
    assert (plan["slabs"], plan["ct"]) == (slabs, ct)


def test_dwconv_smem_is_the_kernels():
    """Three stages of rows + kt - 1 staged rows and two output tiles of
    rows rows, each row the 16-byte chunks of ct * item bytes from any
    start (kt 4 or 5 exactly, else 8)."""
    assert _dwconv_smem(2, 160, 5, 4) == (3 * 68 + 2 * 64) * 336
    assert _dwconv_smem(2, 160, 4, 4) == (3 * 67 + 2 * 64) * 336
    assert _dwconv_smem(2, 7, 3, 9) == (3 * 151 + 2 * 144) * 32
    assert _dwconv_smem(4, 256, 1, 1) == (3 * 23 + 2 * 16) * 1040


@pytest.mark.parametrize("B,L,C,K", [(1, 8, 16, 9), (1, 8, 16, 0),
                                     (0, 8, 16, 5), (1, 0, 16, 5),
                                     (1, 8, 0, 5)])
def test_dwconv_plan_refuses_past_the_bounds(B, L, C, K):
    with pytest.raises(ValueError, match="kernel takes K <= 8"):
        _dwconv_plan(B, L, C, K, max(C, 1), 2, 0, 132)


# --------------------------------------------------------------------------
# bidirectional scan (row 6)
# --------------------------------------------------------------------------

@FAST
@given(B=st.integers(1, 1 << 20), L=st.integers(1, 64),
       D=st.integers(1, 1024), N=st.integers(1, 16),
       item=st.sampled_from([2, 4]), aligned=st.booleans(),
       shared=st.booleans())
def test_bidir_plan_fits_a_block_over_the_domain(B, L, D, N, item, aligned,
                                                 shared):
    plan = _bidir_plan(B, L, D, N, item, aligned, shared)
    tps = -(-D // 2)
    if plan["route"] == "walk":
        assert plan["seqs"] == 0 and not plan["shared"]
        assert (L > 32 or N > 8 or tps > 256 or not aligned
                or D * item % 16
                or _bidir_smem(L, D, N, item, 1, shared) > SMEM_BLOCK)
        assert plan["threads"] <= 256 and plan["grid"][0] == B
        assert plan["grid"][1] * plan["threads"] >= D
        return
    seqs = plan["seqs"]
    assert L <= 32 and N <= 8 and 1 <= seqs <= B and D % 2 == 0
    assert aligned and D * item % 16 == 0 and plan["shared"] == shared
    assert plan["threads"] == seqs * tps <= 256
    if seqs * tps < 128:
        # fewer than 128 threads only where no whole-warp block of 128 or
        # more fits
        assert not [c for c in range(1, min(256 // tps, B) + 1)
                    if c * tps % 32 == 0 and c * tps >= 128
                    and _bidir_smem(L, D, N, item, c, shared) <= SMEM_BLOCK]
    assert plan["lmax"] == (8 if L <= 8 else 16 if L <= 16 else 32)
    assert L <= plan["lmax"]
    assert plan["nmax"] == (4 if N <= 4 else 8) and N <= plan["nmax"]
    assert plan["smem"] == _bidir_smem(L, D, N, item, seqs, shared)
    assert plan["smem"] <= SMEM_BLOCK
    assert plan["grid"] == (-(-B // seqs),)


def test_bidir_plan_at_the_served_shapes():
    """vsrm's composed bissm (57600, 7, 128, N 4), u, B and C shared: the
    tile kernel, two sequences (four whole warps) a block, 11,200 bytes (per
    sequence x and both dt tiles, one B/C set); the per-pixel bimamba's N
    16 keeps the walking kernel."""
    vsrm = _bidir_plan(57600, 7, 128, 4, 2, True, True)
    assert (vsrm["route"], vsrm["seqs"], vsrm["threads"], vsrm["grid"]) == (
        "tile", 2, 128, (28800,))
    assert (vsrm["lmax"], vsrm["nmax"], vsrm["smem"]) == (8, 4, 11200)
    pix = _bidir_plan(57600, 7, 128, 16, 2, True, False)
    assert (pix["route"], pix["grid"], pix["threads"]) == (
        "walk", (57600, 1), 128)


@pytest.mark.parametrize("L,D,N,item,aligned,route", [
    (7, 128, 4, 2, True, "tile"), (7, 128, 8, 2, True, "tile"),
    (32, 128, 8, 2, True, "tile"), (33, 128, 4, 2, True, "walk"),
    (7, 128, 9, 2, True, "walk"), (7, 128, 16, 2, True, "walk"),
    (7, 128, 4, 2, False, "walk"), (7, 130, 4, 2, True, "walk"),
    (7, 130, 4, 4, True, "walk"), (7, 132, 4, 4, True, "tile"),
    (7, 512, 4, 2, True, "tile"), (7, 520, 4, 2, True, "walk")])
def test_bidir_plan_picks_the_kernel(L, D, N, item, aligned, route):
    for shared in (True, False):
        plan = _bidir_plan(1000, L, D, N, item, aligned, shared)
        assert plan["route"] == route
        assert plan["shared"] == (shared and route == "tile")


def test_bidir_route_of_the_wrappers_operands():
    """What the wrapper hands the plan: u passed for both streams is one
    view (read once), a copy of it or another column slice is not; a
    dense tensor is on the 16-byte grid, a slice 3 columns in (or an odd
    width) is not, a slice 8 bf16 columns in is."""
    x = torch.zeros((4, 7, 136), dtype=torch.bfloat16)
    u = x[..., 8:]
    proj = torch.zeros((4, 7, 12), dtype=torch.bfloat16)
    Bm, Cm = proj[..., 4:8], proj[..., 8:]
    assert _same_view(u, u) and _same_view(Bm, proj[..., 4:8])
    assert not _same_view(u, u.clone()) and not _same_view(Bm, Cm)
    assert not _same_view(u, x[..., :128])
    assert _on_16_byte_grid(u, x) and _on_16_byte_grid(u.contiguous())
    assert not _on_16_byte_grid(x[..., 3:])
    assert not _on_16_byte_grid(torch.zeros((4, 7, 9), dtype=torch.bfloat16))


def test_bidir_smem_is_the_kernels():
    """Per sequence 3 (shared) or 4 tiles of L rows of D rounded up to 8,
    then 1 or 2 sets of B and C as fp32, L rows of twice the N bound."""
    assert _bidir_smem(7, 128, 4, 2, 1, True) == 3 * 7 * 128 * 2 + 7 * 8 * 4
    assert _bidir_smem(7, 128, 8, 2, 2, False) == 2 * (
        4 * 7 * 128 * 2 + 2 * 7 * 16 * 4)
    assert _bidir_smem(32, 95, 3, 4, 1, False) == 4 * 32 * 96 * 4 + \
        2 * 32 * 8 * 4


@pytest.mark.parametrize("B,L,D,N", [(10, 8, 16, 17), (0, 8, 16, 4),
                                     (10, 0, 16, 4), (10, 8, 0, 4)])
def test_bidir_plan_refuses_past_the_bounds(B, L, D, N):
    with pytest.raises(ValueError, match="kernel takes N <= 16"):
        _bidir_plan(B, L, D, N, 2, True, True)


# --------------------------------------------------------------------------
# shared bidirectional scan (row 10)
# --------------------------------------------------------------------------

@FAST
@given(B=st.integers(1, 1 << 20), L=st.integers(1, 33),
       D=st.integers(1, 1024), N=st.integers(1, 16),
       item=st.sampled_from([2, 4]), aligned=st.booleans())
def test_shared_scan_plan_fits_a_block_over_the_domain(B, L, D, N, item,
                                                       aligned):
    """Row 10: the tile route stays within 256 threads and a block's shared
    memory (its fp32 tile counted), with the fewest sequences a block that
    fill whole warps and at least 96 threads where one fits; the register
    kernel up to L 32 and the workspace kernel beyond, a block a sequence,
    take the rest."""
    plan = _shared_scan_plan(B, L, D, N, item, aligned)
    if plan["route"] != "tile_sum":
        assert plan["route"] == ("register" if L <= 32 else "workspace")
        assert plan["seqs"] == 0 and plan["smem"] == 0
        assert plan["threads"] <= 256 and plan["grid"][0] == B
        assert plan["grid"][1] * plan["threads"] >= D
        return
    seqs = plan["seqs"]
    assert L <= 32 and N <= 8 and D % 2 == 0 and aligned
    assert D * item % 16 == 0 and 1 <= seqs <= B
    assert plan["threads"] == seqs * D // 2 <= 256
    assert plan["smem"] == _bidir_smem(L, D, N, item, seqs, True, True)
    assert plan["smem"] <= SMEM_BLOCK
    assert plan["grid"] == (-(-B // seqs),)
    if seqs * D // 2 < 96:
        # fewer than three warps only where no whole-warp block of 96
        # threads or more fits
        assert not [c for c in range(1, min(512 // D, B) + 1)
                    if c * D // 2 % 32 == 0 and c * D // 2 >= 96
                    and _bidir_smem(L, D, N, item, c, True, True)
                    <= SMEM_BLOCK]
    row6 = _bidir_plan(B, L, D, N, item, aligned, True, summed=True)
    assert (row6["route"], row6["seqs"]) == ("tile", seqs)


def test_shared_scan_plan_at_the_served_shapes():
    """vsrm's composed bissm (57600, 7, 128, N 4): two sequences (128
    threads) a block, per sequence u and both dt tiles, one B/C set and the
    fp32 tile (7 rows of 128); fast_mamba_vsr's (57600, 16, 96, N 8): two
    sequences (96 threads, three whole warps) a block, where row 6's plan
    takes four (192 threads)."""
    vsrm = _shared_scan_plan(57600, 7, 128, 4, 2, True)
    assert (vsrm["route"], vsrm["seqs"], vsrm["threads"], vsrm["grid"]) == (
        "tile_sum", 2, 128, (28800,))
    assert (vsrm["nmax"], vsrm["smem"]) == (4, 18368) and "lmax" not in vsrm
    assert 18368 == 2 * (3 * 7 * 128 * 2 + 7 * 8 * 4 + 7 * 128 * 4)
    fmv = _shared_scan_plan(57600, 16, 96, 8, 2, True)
    assert (fmv["route"], fmv["seqs"], fmv["threads"], fmv["grid"]) == (
        "tile_sum", 2, 96, (28800,))
    assert (fmv["nmax"], fmv["smem"]) == (8, 32768)
    assert 32768 == 2 * (3 * 16 * 96 * 2 + 16 * 16 * 4 + 16 * 96 * 4)
    assert _bidir_plan(57600, 16, 96, 8, 2, True, True)["seqs"] == 4


@pytest.mark.parametrize("L,D,N,item,aligned,route", [
    (7, 128, 4, 2, True, "tile_sum"), (16, 96, 8, 2, True, "tile_sum"),
    (1, 8, 1, 4, True, "tile_sum"), (32, 128, 8, 2, True, "tile_sum"),
    (33, 128, 4, 2, True, "workspace"), (7, 128, 4, 2, False, "register"),
    (16, 96, 8, 2, False, "register"), (7, 128, 9, 2, True, "register"),
    (7, 128, 16, 2, True, "register"), (7, 130, 4, 2, True, "register"),
    (7, 520, 4, 2, True, "register"), (40, 64, 8, 2, True, "workspace")])
def test_shared_scan_plan_picks_the_kernel(L, D, N, item, aligned, route):
    """Row 10: the tile kernel up to L 32, N 8 and D 512 with u and both dt
    on the 16-byte grid (off it, as a slice 3 columns in, or at N 9-16 the
    register kernel); past L 32 the workspace kernel."""
    assert _shared_scan_plan(1000, L, D, N, item, aligned)["route"] == route


def test_shared_scan_smem_adds_the_fp32_tile():
    """Row 10's shared memory is row 6's for shared streams plus an fp32
    tile of L rows of D rounded up to 8, per sequence."""
    for L, D, N, item, seqs in ((7, 128, 4, 2, 2), (16, 96, 8, 2, 4),
                                (32, 95, 3, 4, 1)):
        assert _bidir_smem(L, D, N, item, seqs, True, True) == (
            _bidir_smem(L, D, N, item, seqs, True)
            + seqs * L * _up(D, 8) * 4)


@pytest.mark.parametrize("B,L,D,N", [(10, 8, 16, 17), (0, 8, 16, 4),
                                     (10, 0, 16, 4), (10, 8, 0, 4)])
def test_shared_scan_plan_refuses_past_the_bounds(B, L, D, N):
    with pytest.raises(ValueError, match="kernel takes N <= 16"):
        _shared_scan_plan(B, L, D, N, 2, True)
