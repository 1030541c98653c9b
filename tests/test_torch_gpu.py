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


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", [None, "relu", "relu2", "silu", "gelu"])
@pytest.mark.parametrize("mkn", [(256, 4096, 4096), (300, 700, 520),
                                 (1, 4100, 17), (129, 64, 136),
                                 # sm90 edges: ragged M, M = 1, N = 576 and
                                 # 8, K = 64 and 8, 96 and 320 tiles
                                 (1000, 576, 1536), (1, 4096, 4096),
                                 (1000, 1536, 576), (300, 64, 8),
                                 (130, 8, 520), (3000, 1024, 1000),
                                 (5000, 512, 2048),
                                 # fp32: K % 4 != 0 (f32_edge); 768^3
                                 (64, 702, 128), (768, 768, 768),
                                 # smollm-135m's decode FFN at B = 8, 64
                                 (8, 576, 1536), (8, 1536, 576),
                                 (64, 576, 1536), (64, 1536, 576)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version(cuda, dtype, mkn, act, with_bias):
    """Every kernel and, in fp32, both tiles of ``f32_plan``: 64x128 at
    (256, 4096, 4096), (1000, 576, 1536), (1000, 1536, 576), the last
    three sm90 edges and 768^3; 32x64 at the others that f32 takes."""
    from repro_torch.kernels.blocked_matmul import aligned, variant
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(M * 7 + N)
    a = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    b = torch.randn((K, N), generator=gen, device=cuda).to(dtype)
    bias = (torch.randn((N,), generator=gen, device=cuda).to(dtype)
            if with_bias else None)
    kind = variant(M, N, K, dtype, aligned(a, b, bias))
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, bias=bias, act=act)
    torch.cuda.synchronize()
    assert blocked_matmul.launches_by_variant == {
        **before, kind: before[kind] + 1}
    assert got.shape == (M, N) and got.dtype == dtype
    assert _rel_err(got, ref_matmul(a, b, bias=bias, act=act)) < TOL[dtype]


def test_variant_counters_follow_the_rule(cuda):
    from repro_torch.kernels.blocked_matmul import variant
    gen = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randn(64 * 64 + 1, generator=gen, device=cuda)
    b = torch.randn((64, 128), generator=gen, device=cuda)
    cases = [(flat[:4096].view(64, 64).bfloat16(), b.bfloat16(), "sm90"),
             (flat.bfloat16()[1:].view(64, 64), b.bfloat16(), "wmma"),
             (flat[:4096].view(64, 64), b, "f32"),
             (flat[1:].view(64, 64), b, "f32_edge")]
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
    sm90 = bm._launcher().sm90
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bn, bias in ((96, None), (128, out.view(-1)[1:129])):  # bias off 2 B
        rc = sm90(a.data_ptr(), b.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  128, 128, 64, 0, bn, 1, stream)
        assert rc == 1   # cudaErrorInvalidValue


def test_f32_rejects_what_it_was_not_built_for(cuda):
    from repro_torch.kernels import blocked_matmul as bm
    flat = torch.ones(128 * 64 + 4, device=cuda)
    a = flat[:128 * 64].view(128, 64)
    out = torch.empty((128, 128), device=cuda)
    f32 = bm._launcher().f32
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for a_ptr, n, tile in ((a.data_ptr(), 128, (128, 128)),   # not built
                           (a.data_ptr(), 126, (64, 128)),    # N % 4 != 0
                           (flat[1:].data_ptr(), 128, (64, 128))):  # off 4 B
        rc = f32(a_ptr, a.data_ptr(), None, out.data_ptr(), 128, n, 64, 0,
                 *tile, stream)
        assert rc == 1   # cudaErrorInvalidValue


def test_f32_takes_an_unaligned_base_to_the_edge_kernel(cuda):
    from repro_torch.kernels.blocked_matmul import aligned, variant
    gen = torch.Generator(device=cuda).manual_seed(7)
    flat = torch.randn(300 * 512 + 1, generator=gen, device=cuda)
    a = flat[1:].view(300, 512)
    assert a.data_ptr() % 16 == 4
    b = torch.randn((512, 520), generator=gen, device=cuda)
    bias = torch.randn((520,), generator=gen, device=cuda)
    assert variant(300, 520, 512, torch.float32,
                   aligned(a, b, bias)) == "f32_edge"
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, bias=bias, act="gelu")
    torch.cuda.synchronize()
    assert blocked_matmul.launches_by_variant == {
        **before, "f32_edge": before["f32_edge"] + 1}
    assert _rel_err(got, ref_matmul(a, b, bias=bias, act="gelu")) \
        < TOL[torch.float32]


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


def test_kernels_refuse_autograd_on_the_card(cuda):
    """The kernels give no gradient, so a CUDA input that requires grad
    under grad mode raises instead of returning a result cut off from the
    graph; under no_grad the same call launches."""
    a = torch.randn((64, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    q = torch.randn((1, 4, 64, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn((1, 2, 64, 64), device=cuda, dtype=torch.bfloat16)
    launches = (blocked_matmul.launches, flash_attention_bhsd.launches)
    with pytest.raises(RuntimeError, match="forward-only"):
        blocked_matmul(a, a.detach())
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_bhsd(q, kv, kv)
    assert (blocked_matmul.launches, flash_attention_bhsd.launches) == launches
    with torch.no_grad():
        blocked_matmul(a, a)
        flash_attention_bhsd(q, kv, kv)
    assert (blocked_matmul.launches, flash_attention_bhsd.launches) == (
        launches[0] + 1, launches[1] + 1)
    cfg = get_config("smollm-135m").replace(n_layers=2, vocab_size=512,
                                            use_flash=True,
                                            use_kernel_matmul=True)
    from repro_torch.train.loop import make_loss_fn
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    for p in params["blocks"][0]["ffn"].values():
        p.requires_grad_(True)
    toks = torch.randint(0, 512, (2, 65), device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        make_loss_fn(cfg)(params, {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]})


def test_decode_step_launches_the_ffn_kernel_and_no_flash(cuda):
    """Three blocked-matmul launches a layer a step (all sm90 in bf16),
    no flash launch with use_flash on; the logits agree with the plain
    path's decode."""
    from repro_torch.kernels import blocked_matmul as bm
    cfg = get_config("smollm-135m").replace(n_layers=2, vocab_size=512,
                                            use_flash=True,
                                            use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 512, (8, 6), device=cuda)
    caches = [transformer.init_cache(c, 8, 16) for c in (cfg, plain)]
    before = (dict(bm.blocked_matmul.launches_by_variant),
              flash_attention_bhsd.launches)
    with torch.no_grad():
        for t in range(6):
            got, _ = transformer.decode_step(params, tokens[:, t:t + 1],
                                             caches[0], t, cfg)
            want, _ = transformer.decode_step(params, tokens[:, t:t + 1],
                                              caches[1], t, plain)
            assert _rel_err(got, want) < 2e-2
    assert bm.blocked_matmul.launches_by_variant == {
        **before[0], "sm90": before[0]["sm90"] + 6 * 3 * 2}
    assert flash_attention_bhsd.launches == before[1]


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


def test_moe_kernel_path_matches_the_plain_path_on_its_routing(cuda):
    """The reduced qwen2-moe widened to dh 128 (a head dim the flash kernel
    takes) on the card: the kernel path (``use_flash``; the shared experts'
    products in the blocked matmul) against the plain path, with the plain
    path's routing replayed (``chip_smoke.routes_replayed``), so a near-tied
    top-k choice that the two roundings break apart does not count.  Two
    flash and six sm90 launches a forward; six and no flash a decode step."""
    from chip_smoke import LM_TOL, routes_recorded, routes_replayed, \
        row_rel_err
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import blocked_matmul as bm
    cfg = get_reduced("qwen2-moe-a2.7b").replace(
        d_model=256, n_heads=2, n_kv_heads=2, moe_d_ff=64,
        n_shared_experts=2, use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    params = transformer.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 256), device=cuda)
    mm, flash = bm.blocked_matmul, flash_attention_bhsd
    with torch.no_grad():
        log = []
        with routes_recorded(log):
            want, _ = transformer.forward(params, tokens, plain)
        before = (dict(mm.launches_by_variant), flash.launches)
        with routes_replayed(log):
            got, aux = transformer.forward(params, tokens, cfg)
        assert mm.launches_by_variant == {**before[0],
                                          "sm90": before[0]["sm90"] + 6}
        assert flash.launches == before[1] + 2
        assert got.shape == (2, 256, 512) and torch.isfinite(aux)
        assert row_rel_err(got, want) < LM_TOL
        caches = [transformer.init_cache(c, 2, 8) for c in (cfg, plain)]
        for t in range(8):
            tok, log = tokens[:, t:t + 1], []
            with routes_recorded(log):
                want, _ = transformer.decode_step(params, tok, caches[1], t,
                                                  plain)
            m0, f0 = mm.launches, flash.launches
            with routes_replayed(log):
                got, _ = transformer.decode_step(params, tok, caches[0], t, cfg)
            assert (mm.launches - m0, flash.launches - f0) == (6, 0)
            assert row_rel_err(got, want) < LM_TOL


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("mkn", [(16384, 1600, 5504), (16384, 5504, 1600),
                                 (8, 1600, 5504), (8, 5504, 1600)])
def test_kernel_at_hymba_ffn_shapes(cuda, mkn, act):
    """hymba-1.5b's FFN in prefill (8 x 2048 tokens) and decode (B = 8):
    K = 1600 is 25 k-tiles of 64, and N = 1600 leaves a 64-wide edge tile
    at widths of 128 for the masked store.  bf16, the sm90 variant."""
    from repro_torch.kernels.blocked_matmul import variant
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    a = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    b = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(
        torch.bfloat16)
    assert variant(M, N, K, torch.bfloat16, True) == "sm90"
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, act=act)
    torch.cuda.synchronize()
    assert blocked_matmul.launches_by_variant == {
        **before, "sm90": before["sm90"] + 1}
    assert _rel_err(got, ref_matmul(a, b, act=act)) < TOL[torch.bfloat16]


def test_hybrid_decode_step_launches_the_ffn_kernel_and_no_flash(cuda):
    """The reduced hymba (3 layers, window 8: the local ring wraps) on the
    card with use_flash and use_kernel_matmul: three sm90 launches a layer
    a step and no flash launch, in the forward and in decode; the logits
    agree with the plain path's."""
    from chip_smoke import LM_TOL, row_rel_err
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import blocked_matmul as bm
    cfg = get_reduced("hymba-1.5b").replace(use_flash=True,
                                            use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    params = transformer.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (8, 12), device=cuda)
    mm, flash = bm.blocked_matmul, flash_attention_bhsd
    with torch.no_grad():
        before = (dict(mm.launches_by_variant), flash.launches)
        got, _ = transformer.forward(params, tokens, cfg)
        assert mm.launches_by_variant == {**before[0],
                                          "sm90": before[0]["sm90"] + 9}
        assert flash.launches == before[1]
        assert row_rel_err(got, transformer.forward(params, tokens, plain)[0]) \
            < LM_TOL
        caches = [transformer.init_cache(c, 8, 12) for c in (cfg, plain)]
        for t in range(12):
            m0, f0 = mm.launches, flash.launches
            got, _ = transformer.decode_step(params, tokens[:, t:t + 1],
                                             caches[0], t, cfg)
            assert (mm.launches - m0, flash.launches - f0) == (9, 0)
            want, _ = transformer.decode_step(params, tokens[:, t:t + 1],
                                              caches[1], t, plain)
            assert row_rel_err(got, want) < LM_TOL


@pytest.mark.parametrize("case", [
    # whisper-tiny's encoder (bidirectional, S = 1500: not a multiple of the
    # tile) and decoder prefill; internvl2-26b's dh 128 at GQA 6 (48 / 8)
    (8, 1500, 6, 6, 64, False), (2, 448, 6, 6, 64, True),
    (1, 1024, 48, 8, 128, True), (2, 300, 48, 8, 128, False)],
    ids=lambda c: "B{}S{}H{}K{}d{}c{:d}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_at_encdec_and_vlm_shapes(cuda, dtype, case):
    from repro_torch.kernels.flash_attention import variant
    B, S, H, K, dh, causal = case
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=cuda)
               .to(dtype) for n in (H, K, K))
    kind = variant(dtype, dh, True)
    before = dict(flash_attention_bhsd.launches_by_variant)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches_by_variant == {
        **before, kind: before[kind] + 1}
    want = ref_flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _row_rel_err(got, want) < FLASH_TOL[dtype]


@pytest.mark.parametrize("mkn, act", [
    ((1500, 384, 1536), "gelu"), ((8, 384, 1536), "gelu"),
    ((1500, 1536, 384), None), ((8, 1536, 384), None)],
    ids=["enc_up", "dec_up", "enc_down", "dec_down"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_at_whisper_ffn_shapes(cuda, dtype, mkn, act):
    """whisper-tiny's FFN: the up product with its bias and the tanh GELU in
    the epilogue, the down product with its bias; 1500 encoder frames and a
    decode step of 8."""
    from repro_torch.kernels.blocked_matmul import aligned, variant
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(dtype)
    bias = torch.randn((N,), generator=gen, device=cuda).to(dtype)
    kind = variant(M, N, K, dtype, aligned(a, b, bias))
    assert kind == ("f32" if dtype == torch.float32 else "sm90")
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, bias=bias, act=act)
    torch.cuda.synchronize()
    assert blocked_matmul.launches_by_variant == {
        **before, kind: before[kind] + 1}
    assert _rel_err(got, ref_matmul(a, b, bias=bias, act=act)) < TOL[dtype]


def test_encdec_paths_launch_the_kernels(cuda):
    """whisper-tiny at full width, one layer each side, on the card with
    use_flash and use_kernel_matmul: encode launches the flash kernel once
    (non-causal) and the FFN kernel twice; the forward adds the decoder's
    causal one and its two; a decode step launches the FFN kernel twice a
    layer and no flash.  Logits within LM_TOL of the plain path by row."""
    from chip_smoke import LM_TOL, row_rel_err
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.models import encdec
    cfg = get_config("whisper-tiny").replace(
        n_layers=1, encoder_layers=1, vocab_size=512, use_flash=True,
        use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    params = encdec.init_encdec(cfg, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    frames = torch.randn((2, 300, cfg.d_model), generator=gen, device=cuda)
    tokens = torch.randint(0, 512, (2, 20), device=cuda)
    mm, flash = bm.blocked_matmul, flash_attention_bhsd
    with torch.no_grad():
        m0, f0 = dict(mm.launches_by_variant), flash.launches
        encdec.encode(params, frames, cfg)
        assert (mm.launches_by_variant["sm90"] - m0["sm90"],
                flash.launches - f0) == (2, 1)
        m0, f0 = mm.launches, flash.launches
        got, _ = encdec.forward(params, tokens, frames, cfg)
        assert (mm.launches - m0, flash.launches - f0) == (4, 2)
        want, _ = encdec.forward(params, tokens, frames, plain)
        assert row_rel_err(got, want) < LM_TOL
        caches = [encdec.init_encdec_cache(params, frames, 2, 20, c)
                  for c in (cfg, plain)]
        for t in range(20):
            m0, f0 = mm.launches, flash.launches
            got, _ = encdec.decode_step(params, tokens[:, t:t + 1],
                                        caches[0], t, cfg)
            assert (mm.launches - m0, flash.launches - f0) == (2, 0)
            want, _ = encdec.decode_step(params, tokens[:, t:t + 1],
                                         caches[1], t, plain)
            assert row_rel_err(got, want) < LM_TOL


def test_vlm_forward_launches_the_dh128_flash_kernel(cuda):
    """internvl2-26b at full width, one layer, with use_flash and
    use_kernel_matmul: the prefixed forward launches the flash kernel once
    at dh 128 and GQA 6 (sm90) and the FFN kernel three times; the logits
    within LM_TOL of the plain path by row."""
    from chip_smoke import LM_TOL, row_rel_err
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.models import vlm
    cfg = get_config("internvl2-26b").replace(
        n_layers=1, vocab_size=512, visual_tokens=16, visual_width=64,
        use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    params = vlm.init_vlm(cfg, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    patches = torch.randn((2, 16, 64), generator=gen, device=cuda)
    tokens = torch.randint(0, 512, (2, 100), device=cuda)
    mm, flash = bm.blocked_matmul, flash_attention_bhsd
    with torch.no_grad():
        m0 = dict(mm.launches_by_variant)
        f0 = dict(flash.launches_by_variant)
        got, _ = vlm.forward(params, tokens, patches, cfg)
        assert mm.launches_by_variant == {**m0, "sm90": m0["sm90"] + 3}
        assert flash.launches_by_variant == {**f0, "sm90": f0["sm90"] + 1}
        want, _ = vlm.forward(params, tokens, patches, plain)
        assert got.shape == (2, 116, 512)
        assert row_rel_err(got, want) < LM_TOL


def test_checkpoint_round_trips_card_state_bit_for_bit(cuda, tmp_path):
    """fp32, bf16 and int32 leaves on the card and a CUDA generator: an
    async save snapshots them when it is called (the leaves are changed in
    place at once), and the restore puts each back on the card, bit for
    bit, the generator with its state."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((300, 577), generator=gen, device=cuda)
    tree = {"w": w, "h": w.to(torch.bfloat16), "rng": gen,
            "n": torch.arange(7, dtype=torch.int32, device=cuda)}
    want = {k: v.clone() for k, v in tree.items() if k != "rng"}
    want_rng = gen.get_state()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, async_=True)
    for k in want:
        tree[k].add_(1)
    torch.rand(3, generator=gen, device=cuda)
    ck.wait()
    like = {"w": torch.zeros_like(w), "h": torch.zeros_like(want["h"]),
            "rng": torch.Generator(device=cuda),
            "n": torch.zeros(7, dtype=torch.int32, device=cuda)}
    got, step = ck.restore(like)
    assert step == 1
    for k, v in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k
    assert got["rng"].device.type == "cuda"
    assert torch.equal(got["rng"].get_state(), want_rng)


def test_runner_times_the_step_on_the_card(cuda, tmp_path):
    """A step whose card work outlasts its enqueue: the runner's timed
    window waits for the loss's device, so each step observes the card's
    ~20 ms, not the host's microseconds."""
    import numpy as np

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.train.fault_tolerance import ResilientRunner, RunnerConfig
    cycles = int(0.02 * torch.cuda.get_device_properties(
        cuda).clock_rate * 1e3)           # clock_rate is in kHz

    class Stream:
        def batch(self, step):
            return {"x": np.zeros(1, np.float32)}

    def step(state, batch):
        torch.cuda._sleep(cycles)
        state = state + 1.0
        return state, {"loss": state.sum(), "ce": state.sum()}

    hist = REGISTRY.histogram("train.step_seconds")
    before = (hist.count, hist.snapshot()["sum"])
    runner = ResilientRunner(step, Checkpointer(str(tmp_path)),
                             RunnerConfig(ckpt_every=100, async_ckpt=False))
    state, history = runner.run(torch.zeros(4, device=cuda), Stream(), 5)
    assert [h["step"] for h in history] == list(range(5))
    assert state.device.type == "cuda" and float(state[0]) == 5.0
    assert hist.count - before[0] == 5
    assert hist.snapshot()["sum"] - before[1] >= 5 * 0.015
