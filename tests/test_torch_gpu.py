"""Card-only tests of the port's CUDA kernels against their plain versions,
at small shapes that reach the kernels' edges (ragged chunks, strided rows,
narrow heads, even conv kernels, every dtype).

They carry the ``gpu`` marker and skip without a card. This file imports no
JAX, so on the card's machine (which has none) it runs with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.nn.ssm import (bissd_apply, bissd_init,
                                             bissm_apply, bissm_init)
from video_enhancer_tpu_torch.ops.scan import (fused_bidir_ssm_kernel,
                                               fused_bidir_ssm_plain)
from video_enhancer_tpu_torch.ops.ssd import (ssd_shared_kernel,
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
    assert _rel(z, bissm_apply(pm, s, use_kernel=False)) <= 2e-2


def test_kernel_rejects_bad_layout(cuda):
    """A head dimension that is not dense is refused, not misread."""
    x = torch.randn((1, 10, 64, 2), device=cuda).transpose(2, 3)
    dt = torch.rand((1, 10, 2), device=cuda)
    Bm = torch.randn((1, 10, 4), device=cuda)
    with pytest.raises(ValueError, match="heads must be dense"):
        ssd_shared_kernel(x, dt, -torch.ones(2, device=cuda), Bm, Bm)
