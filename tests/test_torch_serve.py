"""The port's serve engine and CLI (``repro_torch.serve``,
``repro_torch.launch.serve``) on the CPU, against the JAX package's.

Greedy generation on the reduced smollm-135m in fp32 from the same numpy
weights (JAX's ``init_lm`` tree, filled from numpy) and prompt: the tokens
must be equal, and the run must open the reference's ``serve.generate``
span and time every step into ``serve.step_seconds``.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serve import engine

PROMPT, STEPS, MAX_LEN = (2, 5), 4, 16


def _tree(cfg):
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        n = rng.standard_normal(s.shape)
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * n).astype(np.float32)
        if "embed" in jax.tree_util.keystr(path):
            return (0.02 * n).astype(np.float32)
        return (n / np.sqrt(s.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_greedy_generate_matches_jax_and_is_observed(tmp_path):
    jcfg = jax_get_reduced("smollm-135m").replace(compute_dtype=jnp.float32)
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    tree = _tree(jcfg)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    want = jax_engine.greedy_generate(jax.tree.map(jnp.asarray, tree), jcfg,
                                      jnp.asarray(prompt), steps=STEPS,
                                      max_len=MAX_LEN)
    hist = REGISTRY.histogram("serve.step_seconds")
    before = hist.count
    tracer = trace.enable(str(tmp_path / "t.json"))
    try:
        got = engine.greedy_generate(lm_params_from_numpy(tree, device="cpu"),
                                     cfg, torch.from_numpy(prompt).long(),
                                     steps=STEPS, max_len=MAX_LEN)
    finally:
        trace.disable()
    assert got.shape == (2, PROMPT[1] + STEPS) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :PROMPT[1]].numpy(), prompt)
    assert hist.count - before == PROMPT[1] + STEPS - 1
    spans = [e for e in tracer.to_dict()["traceEvents"]
             if e["ph"] == "X" and e["name"] == "serve.generate"]
    assert [e["args"] for e in spans] == [
        {"arch": "smollm-135m", "batch": 2, "prompt_len": 5, "steps": STEPS}]
    path = tracer.write()
    assert trace.validate_chrome_trace(path)["n_spans"] == 1


def test_serve_step_is_decode_step_and_the_cache_lives_with_the_params():
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    params = lm_params_from_numpy(_tree(jax_get_reduced("smollm-135m")),
                                  device="cpu")
    cache = engine.init_cache(params, cfg, 2, 6)
    assert cache["k"].device.type == "cpu"
    assert cache["k"].shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.dh)
    tok = torch.tensor([[3], [4]])
    logits, out = engine.build_serve_step(cfg)(params, tok, cache, 0)
    assert out is cache and logits.shape == (2, 1, cfg.vocab_size)
    assert cache["k"][:, :, 0].any() and not cache["k"][:, :, 1:].any()


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-26b"])
def test_enc_dec_and_vlm_raise_naming_their_item(arch):
    """Both families serve now (their parity with the JAX package is in
    tests/test_torch_encdec.py and tests/test_torch_vlm.py): the engine
    builds each one's cache on the params' device and steps it in place;
    an enc-dec cache without the encoder's frames raises, naming them."""
    from repro_torch.models import encdec, vlm
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        params = encdec.init_encdec(cfg, gen, device="cpu")
        with pytest.raises(ValueError, match="frames"):
            engine.init_cache(params, cfg, 2, 6)
        frames = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                             generator=gen)
        cache = engine.init_cache(params, cfg, 2, 6, frames=frames)
        assert cache["cross_k"].shape == (cfg.n_layers, 2, cfg.encoder_seq,
                                          cfg.n_kv_heads, cfg.dh)
        kv = cache["self"]
    else:
        params = vlm.init_vlm(cfg, gen, device="cpu")
        cache = kv = engine.init_cache(params, cfg, 2, 6)
    assert kv["k"].device.type == "cpu"
    assert kv["k"].shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.dh)
    tok = torch.tensor([[3], [4]])
    logits, out = engine.build_serve_step(cfg)(params, tok, cache, 0)
    assert out is cache and logits.shape == (2, 1, cfg.vocab_size)
    assert kv["k"][:, :, 0].any() and not kv["k"][:, :, 1:].any()


def test_cli_generates_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", "smollm-135m", "--reduced", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "3",
                           "--new-tokens", "4", "--seed", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"smollm-135m: batch=2 \+4 tokens in [0-9.]+s "
                        r"\([0-9]+ tok/s\)", out[0])
    seq = json.loads(out[1].removeprefix("first sequence: "))
    assert len(seq) == 3 + 4
    assert all(0 <= t < get_reduced("smollm-135m").vocab_size for t in seq)


def test_cli_refuses_a_mesh_and_needs_a_card_by_default(capsys):
    """A mesh larger than the world exits 2 and never shrinks (one process
    is a world of one; on the card more needs several cards, item 4)."""
    assert serve_cli.main(["--arch", "smollm-135m", "--reduced", "--device",
                           "cpu", "--mesh", "2x1"]) == 2
    err = capsys.readouterr().err
    assert "needs 2 ranks" in err and "item 4" in err
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        return                            # None resolves to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "smollm-135m", "--reduced"])


# ---- --mesh ------------------------------------------------------------------


def _first_sequence(text):
    line = [ln for ln in text.splitlines()
            if ln.startswith("first sequence: ")][0]
    return json.loads(line.removeprefix("first sequence: "))


def test_cli_mesh_1x1_serves_the_tokens_of_no_mesh(capsys):
    """``--mesh 1x1 --device cpu``: a world of one (started and taken down
    by the CLI), the params placed through the specs (local tensors on one
    device): the tokens of ``greedy_generate`` with no mesh at all."""
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "3", "--new-tokens", "4",
            "--seed", "5", "--mesh", "1x1"]
    assert serve_cli.main(args) == 0
    assert not torch.distributed.is_initialized()
    got = _first_sequence(capsys.readouterr().out)
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 3),
                           generator=torch.Generator().manual_seed(6))
    want = engine.greedy_generate(params, cfg, prompt, steps=4, max_len=7)
    assert got == want[0].tolist()


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_cli_serves_the_same_tokens_on_two_gloo_ranks(mesh, capsys,
                                                       tmp_path):
    """Two ranks under torchrun: on 1x2 the params are DTensors sharded
    over the model axis, on 2x1 the batch over the data axis; each rank
    prints the tokens of one process (each rank's stdout to a file of its
    own, so the two cannot interleave)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "3", "--new-tokens", "4",
            "--seed", "5"]
    assert serve_cli.main(args) == 0
    want = _first_sequence(capsys.readouterr().out)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", port,
         "--log-dir", str(tmp_path), "--redirects", "1", "-m",
         "repro_torch.launch.serve", *args, "--mesh", mesh], env=env,
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    logs = sorted(tmp_path.rglob("stdout.log"))
    assert len(logs) == 2
    assert [_first_sequence(p.read_text()) for p in logs] == [want, want]
