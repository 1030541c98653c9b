"""Tests of the CUDA kernels that need the card.

They skip without one (the skip is decided in the ``cuda`` fixture, so every
test process collects the same tests).  On the H100, from the repo root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.kernels.ref import ref_matmul
from repro_torch.models import mlp_dlrm

pytestmark = pytest.mark.gpu

#: rel error = max|got - want| / max|want|: fp32 FMAs in another order than
#: cuBLAS (TF32 off); bf16 one output rounding
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("act", [None, "relu", "relu2", "silu", "gelu"])
@pytest.mark.parametrize("mkn", [(256, 4096, 4096), (300, 700, 520),
                                 (1, 4100, 17), (129, 64, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version(cuda, dtype, mkn, act):
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(M * 7 + N)
    a = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    b = torch.randn((K, N), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((N,), generator=gen, device=cuda).to(dtype)
    got = blocked_matmul(a, b, bias=bias, act=act)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == dtype
    assert _rel_err(got, ref_matmul(a, b, bias=bias, act=act)) < TOL[dtype]


def test_launch_counter_rises_once_per_cuda_call(cuda):
    a = torch.randn((4, 33, 40), device=cuda)
    b = torch.randn((40, 24), device=cuda)
    before = blocked_matmul.launches
    got = ops.matmul(a, b, act="relu")
    assert blocked_matmul.launches == before + 1
    ops.matmul(a.cpu(), b.cpu(), act="relu")
    assert blocked_matmul.launches == before + 1
    want = ref_matmul(a.reshape(-1, 40), b, act="relu").reshape(4, 33, 24)
    assert _rel_err(got, want) < TOL[torch.float32]


def test_mlp_forward_launches_one_kernel_per_layer(cuda):
    cfg = get_config("dlrm-mlp").replace(n_layers=3, mlp_widths=(256,) * 3,
                                         d_model=256, use_kernel_matmul=True)
    params = mlp_dlrm.init_mlp(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    x = torch.randn((64, 256), device=cuda)
    before = blocked_matmul.launches
    got = mlp_dlrm.forward(params, x, cfg)
    assert blocked_matmul.launches == before + 3
    want = mlp_dlrm.forward(params, x, cfg.replace(use_kernel_matmul=False))
    assert got.shape == (64,) and _rel_err(got, want) < 2e-2


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError, match="on"):
        blocked_matmul(torch.ones((2, 2), device=cuda), torch.ones((2, 2)))
