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
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ref import ref_flash_attention, ref_matmul
from repro_torch.models import mlp_dlrm, transformer

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
                                 (1, 4100, 17), (129, 64, 136),
                                 # sm90 edges: ragged M, M = 1, N = 576 and
                                 # 8, K = 64 and 8, 96 and 320 tiles
                                 (1000, 576, 1536), (1, 4096, 4096),
                                 (1000, 1536, 576), (300, 64, 8),
                                 (130, 8, 520), (3000, 1024, 1000),
                                 (5000, 512, 2048)])
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


def test_variant_counters_follow_the_rule(cuda):
    from repro_torch.kernels.blocked_matmul import variant
    gen = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randn(64 * 64 + 1, generator=gen, device=cuda)
    b = torch.randn((64, 128), generator=gen, device=cuda)
    cases = [(flat[:4096].view(64, 64).bfloat16(), b.bfloat16(), "sm90"),
             (flat.bfloat16()[1:].view(64, 64), b.bfloat16(), "wmma"),
             (flat[:4096].view(64, 64), b, "f32")]
    for a, b_, kind in cases:
        aligned = a.data_ptr() % 16 == 0
        assert variant(64, 128, 64, a.dtype, aligned) == kind
        before = dict(blocked_matmul.launches_by_variant)
        got = blocked_matmul(a, b_, act="silu")
        torch.cuda.synchronize()
        assert blocked_matmul.launches_by_variant == {
            **before, kind: before[kind] + 1}
        assert _rel_err(got, ref_matmul(a, b_, act="silu")) < TOL[a.dtype]


def test_sm90_rejects_a_plan_it_was_not_built_for(cuda):
    from repro_torch.kernels import blocked_matmul as bm
    a = torch.ones((128, 64), device=cuda, dtype=torch.bfloat16)
    b = a.t().contiguous()
    out = torch.empty((128, 128), device=cuda, dtype=torch.bfloat16)
    _, sm90 = bm._launcher()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bn, bias in ((96, None), (128, out.view(-1)[1:129])):  # bias off 2 B
        rc = sm90(a.data_ptr(), b.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  128, 128, 64, 0, bn, 1, stream)
        assert rc == 1   # cudaErrorInvalidValue


def test_sm90_takes_a_bias_at_a_4_byte_offset(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((256, 64), generator=gen, device=cuda).bfloat16()
    b = torch.randn((64, 128), generator=gen, device=cuda).bfloat16()
    bias = torch.randn(130, generator=gen, device=cuda).bfloat16()[2:]
    assert bias.data_ptr() % 16 == 4
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, bias=bias, act="relu")
    torch.cuda.synchronize()
    assert blocked_matmul.launches_by_variant == {
        **before, "sm90": before["sm90"] + 1}
    assert _rel_err(got, ref_matmul(a, b, bias=bias, act="relu")) \
        < TOL[torch.bfloat16]


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


#: flash attention, rel error vs ``ref_flash_attention``: fp32 FMAs in
#: another order (no TF32); bf16 p rounded before P.V (tests/test_kernels.py)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("case", [
    (2, 512, 4, 2, 64, True, 0), (1, 512, 4, 4, 128, True, 0),
    (1, 1024, 8, 2, 64, True, 256), (2, 512, 6, 3, 64, False, 0),
    (2, 300, 9, 3, 64, True, 0), (3, 1, 4, 2, 128, True, 0),
    (1, 200, 6, 2, 128, False, 50)],
    ids=lambda c: "B{}S{}H{}K{}d{}c{:d}w{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_version(cuda, dtype, case):
    B, S, H, K, dh, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=cuda).to(dtype)
               for n in (H, K, K))
    before = flash_attention_bhsd.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    want = ref_flash_attention(q, k, v, causal=causal, window=window)
    assert _rel_err(got, want) < FLASH_TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_masks_keys_past_seq_len(cuda, causal):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, n, 384, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (6, 2, 2))
    k[:, :, 300:] = 1e4                      # junk the mask must hide
    got = flash_attention_bhsd(q, k, v, causal=causal, seq_len=300)
    want = ref_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               seq_len=300).transpose(1, 2)
    assert _rel_err(got, want) < FLASH_TOL[torch.bfloat16]


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    q, k, v = (torch.ones((1, 64, n, 32), device=cuda) for n in (4, 2, 2))
    before = flash_attention_bhsd.launches
    with pytest.raises(ValueError, match="dh"):
        ops.flash_attention(q, k, v)
    assert flash_attention_bhsd.launches == before


def test_lm_forward_launches_one_flash_kernel_per_layer(cuda):
    cfg = get_config("smollm-135m").replace(n_layers=2, vocab_size=512,
                                            use_flash=True)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 512, (2, 200), device=cuda)
    before = flash_attention_bhsd.launches
    got, _ = transformer.forward(params, tokens, cfg)
    assert flash_attention_bhsd.launches == before + 2
    want, _ = transformer.forward(params, tokens, cfg.replace(use_flash=False))
    assert got.shape == (2, 200, 512) and torch.isfinite(got).all()
    # bf16: the kernel rounds unnormalised p, the plain path scores in bf16
    assert _rel_err(got, want) < 5e-2


def _row_rel_err(got, want):
    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-6)
    return (num / den).max().item()


@pytest.mark.parametrize("layout", ["model", "bhsd"])
@pytest.mark.parametrize("case", [
    # the sm90 kernel's edges: ragged S, S = 1, a window that cuts through
    # 128-key tiles (causal and not), dh 128, GQA groups of 1 and 3
    (2, 300, 9, 3, 64, True, 0), (1, 1000, 4, 2, 64, True, 0),
    (3, 1, 4, 2, 64, True, 0), (1, 1000, 6, 2, 64, True, 100),
    (1, 777, 4, 4, 64, False, 200), (2, 1000, 4, 2, 128, True, 0),
    (1, 1, 2, 1, 128, True, 0), (1, 300, 4, 4, 128, False, 150)],
    ids=lambda c: "B{}S{}H{}K{}d{}c{:d}w{}".format(*c))
def test_sm90_flash_matches_plain_version(cuda, case, layout):
    B, S, H, K, dh, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(S + 7 * H)
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (H, K, K))
    want = ref_flash_attention(q, k, v, causal=causal, window=window)
    before = dict(flash_attention_bhsd.launches_by_variant)
    if layout == "model":       # transposed views of (B, S, heads, dh)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:                       # contiguous (B, heads, S, dh)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = flash_attention_bhsd(qt, kt, vt, causal=causal,
                                   window=window).transpose(1, 2)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches_by_variant == {
        **before, "sm90": before["sm90"] + 1}
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _row_rel_err(got, want) < FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("junk", [1e4, float("nan")], ids=["1e4", "nan"])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_never_reads_keys_past_seq_len(cuda, causal, junk):
    """Keys at or past seq_len hold junk in k and v; the result must be
    that of the same keys zeroed (the values there are masked)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((2, n, 384, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (6, 2, 2))
    want = ref_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               seq_len=300).transpose(1, 2)
    k[:, :, 300:] = junk
    v[:, :, 300:] = junk
    before = flash_attention_bhsd.launches_by_variant["sm90"]
    got = flash_attention_bhsd(q, k, v, causal=causal, seq_len=300)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches_by_variant["sm90"] == before + 1
    assert torch.isfinite(got).all()
    assert _row_rel_err(got, want) < FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_seq_len_zero_gives_zero_rows(cuda, dtype):
    q, k, v = (torch.randn((1, n, 200, 64), device=cuda).to(dtype)
               for n in (4, 2, 2))
    k.fill_(float("nan"))
    got = flash_attention_bhsd(q, k, v, causal=True, seq_len=0)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_flash_launch_counts_follow_the_variant_rule(cuda):
    from repro_torch.kernels.flash_attention import (tma_readable,
                                                     variant)
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn((1, 4, 130, 64), generator=gen, device=cuda)
    kv = torch.randn((1, 1, 130, 64), generator=gen, device=cuda)
    cases = [(q.bfloat16(), kv.bfloat16().expand(1, 2, 130, 64), "mma"),
             (q.bfloat16(), kv.bfloat16().repeat(1, 2, 1, 1), "sm90"),
             (q, kv.repeat(1, 2, 1, 1), "f32")]
    for q_, kv_, kind in cases:
        assert variant(q_.dtype, 64, tma_readable(q_, kv_)) == kind
        before = dict(flash_attention_bhsd.launches_by_variant)
        got = flash_attention_bhsd(q_, kv_, kv_, causal=True)
        torch.cuda.synchronize()
        assert flash_attention_bhsd.launches_by_variant == {
            **before, kind: before[kind] + 1}
        want = ref_flash_attention(q_.transpose(1, 2), kv_.transpose(1, 2),
                                   kv_.transpose(1, 2)).transpose(1, 2)
        assert _row_rel_err(got, want) < FLASH_TOL[q_.dtype]


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three fp32 AdamW steps of the reduced dlrm-mlp (TF32 off): the card's
    cuBLAS and the CPU's BLAS sum in other orders, so loss and grad norm
    within 1e-5, params within 1e-4 of the largest (chip_smoke.STEP_TOL)."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.convert import mlp_params_from_numpy
    from repro_torch.optim.optimizer import AdamW, warmup_cosine
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves

    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    W = cfg.mlp_widths[0]
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.standard_normal((W, W), np.float32) / 8,
                        "b": rng.standard_normal(W, np.float32) / 10}
                       for _ in range(cfg.n_layers)],
            "head": {"w": rng.standard_normal((W, 1), np.float32) / 8,
                     "b": np.zeros(1, np.float32)}}
    batch = {"features": torch.from_numpy(
                 rng.standard_normal((64, W), np.float32)),
             "click": torch.from_numpy(
                 (rng.random(64) < 0.3).astype(np.float32))}
    opt = AdamW(learning_rate=warmup_cosine(1e-2, 2, 10))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = mlp_params_from_numpy(tree, device=dev)
        state = loop.TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev), None)
        step = loop.build_train_step(cfg, opt)
        ms = []
        for _ in range(3):
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            ms.append({k: v.item() for k, v in m.items()})
        out[dev.type] = ([x.cpu() for x in tree_leaves(state.params)], ms)
    (gp, gm), (cp, cm) = out["cuda"], out["cpu"]
    for a, b in zip(gm, cm):
        assert abs(a["loss"] - b["loss"]) < 1e-5 * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-5 * b["grad_norm"]
    scale = max(x.abs().max().item() for x in cp)
    assert max((a - b).abs().max().item() for a, b in zip(gp, cp)) \
        < 1e-4 * scale


def test_calibration_gemms_launch_the_f32_kernel(cuda):
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.measure import microbench
    before = dict(blocked_matmul.launches_by_variant)
    ms = microbench.matmul_benches((64, 256), repeats=1, device=cuda)
    torch.cuda.synchronize()
    assert [dict(m.meta)["via"] for m in ms] == ["ops", "ops"]
    assert all(m.backend == torch.cuda.get_device_name(cuda) for m in ms)
    # each bench: a probe call, 2 warmups and 1 timed call
    assert blocked_matmul.launches_by_variant == {
        **before, "f32": before["f32"] + 2 * 4}
    assert bm.variant(256, 256, 256, torch.float32, True) == "f32"
