"""The port's mlp train step against ``repro.train.loop``, on the CPU.

``get_reduced("dlrm-mlp")`` (3 layers of 64) in fp32 compute, AdamW with a
warmup-cosine schedule: JAX's ``init_train_state`` makes the state, which
goes to the port through ``convert.train_state_from_numpy``, and both take
the same numpy batches.  After each of 3 steps the params, the loss and the
pre-clip ``grad_norm`` agree within 1e-5 relative (params: of the tree's
largest value), with ``n_micro`` 1 and 2, from step 0 and from a state
carried over at step 2.  A two-process gloo run checks the data-parallel
step, the collective benches and the calibrate CLI's two-rank path.  The
moe, hybrid and ssm families (reduced qwen2-moe, qwen3-moe, hymba, xlstm)
are held to ``jax.value_and_grad`` of the reference's loss and to 3 of its
AdamW steps, plain and int8-compressed; the donated step to the functional
one, bit for bit.
"""
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.optim import optimizer as jax_opt
from repro.train import loop as jax_loop
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import train_state_from_numpy
from repro_torch.distributed import collectives
from repro_torch.measure import counters
from repro_torch.models import mlp_dlrm
from repro_torch.optim import optimizer as opt
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

TOL = 1e-5
BATCH = 16
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfgs():
    return (jax_get_reduced("dlrm-mlp").replace(compute_dtype=jnp.float32),
            get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    width = get_reduced("dlrm-mlp").mlp_widths[0]
    return [{"features": rng.standard_normal((BATCH, width), np.float32),
             "click": (rng.random(BATCH) < 0.3).astype(np.float32)}
            for _ in range(n)]


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _tree_rel(got_tree, want_tree):
    got = [x.numpy() for x in tree_leaves(got_tree)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want_tree)]
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


@functools.lru_cache(maxsize=None)
def _jax_step(n_micro):
    jcfg, _ = _cfgs()
    jopt = jax_opt.AdamW(learning_rate=jax_opt.warmup_cosine(1e-2, 2, 10))
    step = jax.jit(jax_loop.build_train_step(
        jcfg, jopt, jax_loop.TrainStepConfig(n_micro=n_micro)))
    return step, jax_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)


@pytest.mark.parametrize("start", [0, 2], ids=["step0", "carried_at_2"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_steps_match_jax(n_micro, start):
    jstep, jstate = _jax_step(n_micro)
    _, cfg = _cfgs()
    step = loop.build_train_step(
        cfg, opt.AdamW(learning_rate=opt.warmup_cosine(1e-2, 2, 10)),
        loop.TrainStepConfig(n_micro=n_micro))
    batches = _batches(start + 3)
    for b in batches[:start]:
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   device="cpu")
    assert int(state.step) == start == int(state.opt_state.step)
    for b in batches[start:]:
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
        state, m = step(state, _to_torch(b))
        assert int(m["step"]) == int(jm["step"])
        assert _rel(m["loss"], jm["loss"]) < TOL
        assert _rel(m["grad_norm"], jm["grad_norm"]) < TOL
        assert _tree_rel(state.params, jstate.params) < TOL
    assert int(state.step) == start + 3


def test_step_leaves_its_input_state_alone():
    _, cfg = _cfgs()
    o = opt.AdamW()
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, o,
                                  device="cpu")
    before = [x.clone() for x in tree_leaves(state.params)]
    new, _ = loop.build_train_step(cfg, o)(state, _to_torch(_batches(1)[0]))
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state.params)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(new.params)))


def test_every_family_builds_and_compression_trains():
    from repro_torch.configs import ASSIGNED
    for arch in ASSIGNED:           # every family's step builds (items 8, 9)
        assert callable(loop.build_train_step(get_config(arch), opt.AdamW()))
    # the specs of every family are ported (item 12): the dry-run reads them
    from repro_torch.models import transformer
    for arch in ("smollm-135m", "qwen2-moe-a2.7b", "hymba-1.5b"):
        assert loop.model_param_specs(get_config(arch)) == \
            transformer.lm_specs(get_config(arch))
    # compression (item 11) is ported: the step builds and trains with it
    from repro_torch.optim.compression import (Int8Compressor,
                                               StatelessRoundTrip)
    _, cfg = _cfgs()
    o = opt.AdamW()
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, o,
                                  device="cpu")
    step = loop.build_train_step(cfg, o, loop.TrainStepConfig(
        compression=StatelessRoundTrip(Int8Compressor())))
    assert int(step(state, _to_torch(_batches(1)[0]))[0].step) == 1
    assert loop.model_param_specs(get_reduced("dlrm-mlp")) == \
        mlp_dlrm.mlp_specs(get_reduced("dlrm-mlp"))


@pytest.mark.parametrize("make_opt", [lambda: opt.AdamW(learning_rate=1e-2),
                                      lambda: opt.SGD(learning_rate=1e-2)],
                         ids=["adamw", "sgd"])
def test_donated_step_equals_the_functional_step(make_opt):
    """``TrainStepConfig(donate=True)`` writes the new params and moments
    into the input state's buffers, leaf by leaf, and gives the functional
    step's values bit for bit (reduced qwen2-moe: its aux in the loss)."""
    cfg = get_reduced("qwen2-moe-a2.7b").replace(compute_dtype=torch.float32)
    o = make_opt()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = []
    for donate in (False, True):
        state = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                      o, device="cpu")
        ptrs = [x.data_ptr() for x in tree_leaves(state.params)]
        step = loop.build_train_step(cfg, o, loop.TrainStepConfig(
            donate=donate))
        for _ in range(3):
            state, m = step(state, batch)
        same = [x.data_ptr() for x in tree_leaves(state.params)] == ptrs
        assert same == donate
        runs.append((state, m))
    (a, ma), (b, mb) = runs
    moments = [f for f in a.opt_state._fields if f != "step"]
    for x, y in zip(
            tree_leaves([a.params] + [getattr(a.opt_state, f)
                                      for f in moments]),
            tree_leaves([b.params] + [getattr(b.opt_state, f)
                                      for f in moments])):
        assert torch.equal(x, y)
    assert int(a.opt_state.step) == int(b.opt_state.step) == 3
    assert all(torch.equal(ma[k], mb[k]) for k in ("loss", "ce", "aux"))


def test_mlp_specs_equal_reference():
    from repro.models import mlp_dlrm as jax_mlp
    jcfg, cfg = _cfgs()
    assert mlp_dlrm.mlp_specs(cfg) == jax_mlp.mlp_specs(jcfg)


def test_kernel_path_under_grad_raises():
    _, cfg = _cfgs()
    kcfg = cfg.replace(use_kernel_matmul=True)
    state = loop.init_train_state(torch.Generator().manual_seed(0), kcfg,
                                  opt.SGD(), device="cpu")
    batch = _to_torch(_batches(1)[0])
    with pytest.raises(RuntimeError, match="forward-only blocked_matmul"):
        loop.build_train_step(kcfg, opt.SGD())(state, batch)
    with torch.no_grad():        # scoring through the kernel path stays open
        loss = mlp_dlrm.loss_fn(state.params, batch["features"],
                                batch["click"], kcfg)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("layers", [3, 8])
def test_counted_flops_against_the_analytic_count(layers):
    """FlopCounterMode counts (3L - 1) products of 2·B·W² (layer 0's input
    grad is never formed) plus the head's 6·B·W.  The analytic 6·B·W²·L
    counts L of each, so the ratio is 1 - 1/(3L) + 1/(W·L): 0.894 at the
    reduced depth of 3, 0.960 at the paper's 8, which is the depth the
    0.9–1.3 gate of ``benchmarks/run.py`` reads."""
    _, cfg = _cfgs()
    width = cfg.mlp_widths[0]
    cfg = cfg.replace(n_layers=layers, mlp_widths=(width,) * layers)
    o = opt.AdamW()
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, o,
                                  device="cpu")
    flops, nbytes = counters.count(loop.build_train_step(cfg, o), state,
                                   _to_torch(_batches(1)[0]))
    assert flops == 2.0 * BATCH * width ** 2 * (3 * layers - 1) \
        + 6.0 * BATCH * width
    analytic = mlp_dlrm.analytic_work_unit(BATCH, width, layers)[0]
    if layers == 8:
        assert 0.9 < flops / analytic < 1.3
    # eager traffic: at least the fp32 params read and written and the two
    # AdamW moments read and written
    assert nbytes > 6 * 4 * sum(x.numel() for x in tree_leaves(state.params))


# ---- the dense family: lm_loss and remat ---------------------------------------

@functools.lru_cache(maxsize=None)
def _lm_case():
    """Reduced smollm-135m in fp32: JAX's ``init_lm`` tree filled from
    numpy (norm scales moved off 1), and a batch of next-token labels."""
    from repro.models import transformer as jax_tf
    jcfg = jax_get_reduced("smollm-135m").replace(compute_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)

    def fill(path, s):
        n = rng.standard_normal(s.shape)
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * n).astype(np.float32)
        if "embed" in jax.tree_util.keystr(path):
            return (0.02 * n).astype(np.float32)
        return (n / np.sqrt(s.shape[-2])).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    return jcfg, tree, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _lm_grads(cfg, tree, batch):
    from repro_torch.convert import lm_params_from_numpy
    params = lm_params_from_numpy(tree, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loop.make_loss_fn(cfg)(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def test_lm_loss_grads_match_jax_grad():
    from repro_torch.convert import lm_params_from_numpy
    jcfg, tree, batch = _lm_case()
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_loop.make_loss_fn(jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, tree),
            jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _lm_grads(cfg, tree, batch)
    assert _rel(loss.item(), float(jloss)) < TOL
    assert _rel(metrics["ce"].item(), float(jm["ce"])) < TOL
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    # the reference's grads in the port's layout (blocks unstacked)
    want = tree_leaves(lm_params_from_numpy(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    assert [g.shape for g in grads] == [w.shape for w in want]
    scale = max(w.abs().max().item() for w in want)
    assert max((g - w).abs().max().item()
               for g, w in zip(grads, want)) / scale < TOL


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_grads_of_none(remat):
    _, tree, batch = _lm_case()
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    loss, _, want = _lm_grads(cfg, tree, batch)
    got_loss, _, got = _lm_grads(cfg.replace(remat=remat), tree, batch)
    assert got_loss.item() == loss.item()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)


def test_dense_step_trains_on_the_cpu():
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32,
                                             remat="dots")
    o = opt.AdamW(learning_rate=1e-2)
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, o,
                                  device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = loop.build_train_step(cfg, o)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(state.step) == 3


# ---- two processes over gloo -------------------------------------------------

_WORKER = r"""
import os
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_reduced
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.measure import calibrate, microbench
from repro_torch.optim import optimizer as opt
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

rank, init, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
# the calibrate CLI as torchrun would start it: both ranks measure, the
# all-reduces included; rank 0 fits and writes
os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[5])
cli_rc = calibrate.main(["--device", "cpu", "--smoke", "--no-steps",
                         "--repeats", "1", "--out", sys.argv[6]])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2)
d = np.load(data)
cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
layers = [{"w": d[f"w{i}"], "b": d[f"b{i}"]} for i in range(cfg.n_layers)]
params = mlp_params_from_numpy(
    {"layers": layers, "head": {"w": d["hw"], "b": d["hb"]}}, device="cpu")
o = opt.AdamW(learning_rate=1e-2)
state = loop.TrainState(params, o.init(params),
                        torch.zeros((), dtype=torch.int32), None)
half = len(d["x"]) // 2
rows = slice(rank * half, (rank + 1) * half)
state, m = loop.build_train_step(cfg, o)(
    state, {"features": torch.from_numpy(d["x"][rows]),
            "click": torch.from_numpy(d["y"][rows])})
ms = microbench.collective_benches((), sizes_kb=(4, 16), repeats=2,
                                   device="cpu")
np.savez(out, cli_rc=cli_rc, loss=m["loss"].numpy(),
         grad_norm=m["grad_norm"].numpy(),
         names=np.array([x.work.name for x in ms]),
         net=np.array([[x.work.net_bytes, x.work.net_steps, x.work.mem_bytes]
                       for x in ms]),
         links=np.array([str(x.link) for x in ms]),
         cats=np.array([x.category for x in ms]),
         **{f"p{i}": x.numpy() for i, x in enumerate(tree_leaves(state.params))})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Two ranks, each the calibrate CLI (smoke, no steps, 1 repeat), one
    step on its half of a batch of 16 and the collective benches at 4 and
    16 KB; ``(data, [rank0, rank1], registry dir)``."""
    tmp = tmp_path_factory.mktemp("gloo")
    cfg = get_reduced("dlrm-mlp")
    rng = np.random.default_rng(7)
    W, L = cfg.mlp_widths[0], cfg.n_layers
    data = {"x": rng.standard_normal((BATCH, W), np.float32),
            "y": (rng.random(BATCH) < 0.3).astype(np.float32),
            "hw": rng.standard_normal((W, 1), np.float32) / 8,
            "hb": np.zeros(1, np.float32)}
    for i in range(L):
        data[f"w{i}"] = rng.standard_normal((W, W), np.float32) / 8
        data[f"b{i}"] = rng.standard_normal(W, np.float32) / 10
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with socket.socket() as sock:         # a free port for the CLI's group
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp / "init"),
         str(tmp / "data.npz"), str(tmp / f"rank{r}.npz"), port,
         str(tmp / "cal")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    return data, [np.load(tmp / f"rank{r}.npz") for r in range(2)], tmp / "cal"


def test_two_rank_step_equals_the_whole_batch_step(gloo_run):
    data, ranks, _ = gloo_run
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    L = cfg.n_layers
    params = {"layers": [{"w": torch.from_numpy(data[f"w{i}"]),
                          "b": torch.from_numpy(data[f"b{i}"])}
                         for i in range(L)],
              "head": {"w": torch.from_numpy(data["hw"]),
                       "b": torch.from_numpy(data["hb"])}}
    o = opt.AdamW(learning_rate=1e-2)
    state = loop.TrainState(params, o.init(params),
                            torch.zeros((), dtype=torch.int32), None)
    state, m = loop.build_train_step(cfg, o)(
        state, {"features": torch.from_numpy(data["x"]),
                "click": torch.from_numpy(data["y"])})
    want = [x.numpy() for x in tree_leaves(state.params)]
    scale = max(float(np.max(np.abs(w))) for w in want)
    for r in ranks:
        got = [r[f"p{i}"] for i in range(len(want))]
        err = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
        assert err < 1e-6 * scale
        assert _rel(r["loss"], m["loss"].numpy()) < 1e-6
        assert _rel(r["grad_norm"], m["grad_norm"].numpy()) < 1e-6


def test_collective_benches_are_ring_priced_under_gloo(gloo_run):
    _, ranks, _ = gloo_run
    for r in ranks:
        assert list(r["names"]) == ["allreduce_4kb_x2", "allreduce_16kb_x2"]
        assert list(r["cats"]) == ["network"] * 2
        assert list(r["links"]) == ["net"] * 2
        for (net, steps, mem), kb in zip(r["net"], (4, 16)):
            cost = collectives.all_reduce(kb * 1024.0, 2, "ring")
            assert net == float(cost.wire_bytes) == kb * 1024.0
            assert steps == float(cost.steps) == 2.0
            assert mem == 2.0 * kb * 1024


def test_calibrate_cli_measures_the_network_with_two_ranks(gloo_run):
    _, ranks, registry = gloo_run
    assert [int(r["cli_rc"]) for r in ranks] == [0, 0]
    assert [p.name for p in registry.iterdir()] == ["h100_sxm_fp32_cal.json"]
    entry = json.loads((registry / "h100_sxm_fp32_cal.json").read_text())
    assert entry["sources"]["net_bw"] == "measured"
    nets = [m for m in entry["measurements"] if m["category"] == "network"]
    assert [m["name"] for m in nets] == [
        f"allreduce_{kb}kb_x2" for kb in (16, 64, 256)] + [
        f"allreduce_{mb}mb_x2" for mb in (4, 16)]


def test_collective_benches_need_two_ranks():
    from repro_torch.measure import microbench
    assert microbench.collective_benches(device="cpu") == []


# ---- the moe, hybrid and ssm families --------------------------------------------
#
# Reduced configs in fp32, tokens (2, SEQ + 1): hymba's SSD runs three chunks
# of 8 and its local layer's window of 8 is crossed; the MoE's one group of
# 2·SEQ tokens has 15 slots an expert at capacity_factor 1.25, where choices
# drop (asserted), and none drop at E / k.

SEQ = 24
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "hymba-1.5b",
                "xlstm-125m")
#: (arch, capacity_factor): the MoE configs at the default and at E / k
FAMILY_CASES = [("qwen2-moe-a2.7b", 1.25), ("qwen2-moe-a2.7b", 4.0),
                ("qwen3-moe-30b-a3b", 1.25), ("qwen3-moe-30b-a3b", 4.0),
                ("hymba-1.5b", None), ("xlstm-125m", None)]
_ONE = ("scale", "skip_scale", "beta_attn", "beta_mamba", "D_skip",
        "q_norm", "k_norm")


def _family_cfgs(arch, cf=None):
    kw = {} if cf is None else {"capacity_factor": cf}
    return (jax_get_reduced(arch).replace(compute_dtype=jnp.float32, **kw),
            get_reduced(arch).replace(compute_dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _family_tree(arch):
    """The reference ``init_lm`` tree of ``arch`` (reduced), filled from
    numpy: norm scales and skips about 1, decay and gate biases spread."""
    from repro.models import transformer as jax_tf
    jcfg, _ = _family_cfgs(arch)
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(11)

    def fill(path, s):
        name = str(getattr(path[-1], "key", ""))
        n = rng.standard_normal(s.shape)
        if name in _ONE:
            x = 1.0 + 0.1 * n
        elif name in ("A_log", "b_dt"):
            x = 0.3 * n
        elif name in ("b_if", "b", "r_diag"):
            x = 0.5 * n
        elif name in ("bq", "bk", "bv"):
            x = 0.1 * n
        elif name == "embed":
            x = 0.02 * n
        else:
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _family_batch(arch, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, get_reduced(arch).vocab_size, (2, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_family_grads(arch, cf):
    jcfg, _ = _family_cfgs(arch, cf)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        jax_loop.make_loss_fn(jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, _family_tree(arch)),
            jax.tree.map(jnp.asarray, _family_batch(arch)))
    return (float(loss), float(m["ce"]), float(m["aux"]),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _family_grads(cfg, arch):
    """The port's loss, metrics and grads of the same tree and batch, the
    grads stacked as the reference holds them."""
    from repro_torch.convert import lm_params_from_numpy
    params = lm_params_from_numpy(_family_tree(arch), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, m = loop.make_loss_fn(cfg)(params,
                                     _torch_batch(_family_batch(arch)))
    grads = torch.autograd.grad(loss, leaves)
    from repro_torch.tree import tree_unflatten
    stacked = loop.stack_blocks(tree_unflatten(params, list(grads)), cfg)
    return loss, m, [g.numpy() for g in tree_leaves(stacked)]


def _moe_drops(cfg, arch):
    """Choices past their expert's capacity in layer 0 of the batch."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import attention, moe, transformer
    from repro_torch.models.common import apply_norm
    params = lm_params_from_numpy(_family_tree(arch), device="cpu")
    blk = params["blocks"][0]
    with torch.no_grad():
        x = transformer._embed(params, torch.from_numpy(
            _family_batch(arch)["tokens"]).long(), cfg)
        x = x + attention.apply_attention(
            blk["attn"], apply_norm(blk["attn_norm"], x, cfg), cfg)
        h = apply_norm(blk["ffn_norm"], x, cfg).reshape(-1, cfg.d_model)
        _, idx, _ = moe.route(h @ blk["moe"]["router"], cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - moe._capacity(h.shape[0], cfg)).clamp_min(0).sum())


@pytest.mark.parametrize("arch, cf", FAMILY_CASES)
def test_family_loss_and_grads_match_jax_grad(arch, cf):
    """The loss, ``ce``, ``aux`` and every grad leaf against
    ``jax.value_and_grad`` of the reference's ``lm_loss``: 1e-5 (loss and
    metrics relative, grads of the largest |grad|)."""
    _, cfg = _family_cfgs(arch, cf)
    jloss, jce, jaux, want = _jax_family_grads(arch, cf)
    loss, m, got = _family_grads(cfg, arch)
    assert _rel(loss.item(), jloss) < TOL
    assert _rel(m["ce"].item(), jce) < TOL
    if cfg.family == "moe":
        assert _rel(m["aux"].item(), jaux) < TOL and jaux > 0
        assert loss.item() == pytest.approx(
            m["ce"].item() + cfg.router_aux_weight * m["aux"].item(),
            rel=1e-6)
    else:
        assert float(m["aux"]) == jaux == 0.0
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    assert max(float(np.max(np.abs(g - w)))
               for g, w in zip(got, want)) / scale < TOL


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_capacity_cases_drop_and_do_not(arch):
    """The default capacity drops choices in this batch; E / k drops none."""
    for cf, dropping in ((1.25, True), (4.0, False)):
        _, cfg = _family_cfgs(arch, cf)
        assert (_moe_drops(cfg, arch) > 0) == dropping


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_remat_gives_the_grads_of_none(arch, remat):
    """Checkpointed blocks recompute the same values (the MoE's routing and
    aux included): the loss equal, every grad within 1e-6 relative."""
    _, cfg = _family_cfgs(arch)
    loss, m, want = _family_grads(cfg, arch)
    got_loss, gm, got = _family_grads(cfg.replace(remat=remat), arch)
    assert got_loss.item() == loss.item()
    assert gm["aux"].item() == m["aux"].item()
    for g, w in zip(got, want):
        torch.testing.assert_close(torch.from_numpy(g), torch.from_numpy(w),
                                   rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_trains_on_the_cpu(arch):
    """Each family that waited trains from ``init_train_state`` (ROADMAP
    items 8 and 9): 3 AdamW steps on one batch, the loss finite and
    falling; an MoE's loss is its CE plus ``router_aux_weight`` times the
    aux, the others' aux is 0."""
    _, cfg = _family_cfgs(arch)
    o = opt.AdamW(learning_rate=1e-2)
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, o,
                                  device="cpu")
    step = loop.build_train_step(cfg, o)
    batch = _torch_batch(_family_batch(arch, seed=3))
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(state.step) == 3
    if cfg.family == "moe":
        assert m["aux"].item() > 0.0
        assert m["loss"].item() == pytest.approx(
            m["ce"].item() + cfg.router_aux_weight * m["aux"].item(),
            rel=1e-6)
    else:
        assert m["aux"].item() == 0.0 and m["ce"].item() == m["loss"].item()


FAMILY_LR = 1e-2


@functools.lru_cache(maxsize=None)
def _jax_family_run(arch, compressed):
    """The reference's state before each of 3 jitted AdamW steps, the batch
    it took, its metrics and, compressed, its grads before compression;
    numpy."""
    from repro.optim import compression as jax_comp
    jcfg, _ = _family_cfgs(arch)
    jo = jax_opt.AdamW(learning_rate=FAMILY_LR)
    ts = jax_loop.TrainStepConfig(compression=jax_comp.StatelessRoundTrip(
        jax_comp.Int8Compressor()) if compressed else None)
    step = jax.jit(jax_loop.build_train_step(jcfg, jo, ts))
    grad_fn = jax.jit(jax.value_and_grad(jax_loop.make_loss_fn(jcfg),
                                         has_aux=True))
    params = jax.tree.map(jnp.asarray, _family_tree(arch))
    state = jax_loop.TrainState(params, jo.init(params),
                                jnp.zeros((), jnp.int32),
                                jax.random.PRNGKey(0))
    out = []
    for i in range(3):
        batch = _family_batch(arch, seed=20 + i)
        jb = jax.tree.map(jnp.asarray, batch)
        grads = (jax.tree_util.tree_leaves(grad_fn(state.params, jb)[1])
                 if compressed else None)
        before = jax.tree.map(np.asarray, state)
        state, m = step(state, jb)
        out.append((before, batch, {k: float(m[k]) for k in
                                    ("loss", "ce", "aux", "grad_norm")},
                    grads and [np.asarray(g) for g in grads]))
    return out, jax.tree.map(np.asarray, state)


def _port_lm_state(jstate):
    """The reference's ``TrainState`` (numpy) in the port's layout."""
    from repro_torch.convert import lm_params_from_numpy
    lm = functools.partial(lm_params_from_numpy, device="cpu")
    mu, nu = jstate.opt_state.mu, jstate.opt_state.nu
    return loop.TrainState(lm(jstate.params), opt.AdamWState(
        step=torch.tensor(int(jstate.opt_state.step), dtype=torch.int32),
        mu=lm(mu), nu=lm(nu)), torch.tensor(int(jstate.step),
                                            dtype=torch.int32), None)


def _int8_grid(x):
    """x on the int8 grid of its chunks: x / scale, before rounding."""
    from repro_torch.optim.compression import Int8Compressor
    chunk = Int8Compressor().chunk
    n = x.size
    fp = np.pad(x.reshape(-1), (0, (-n) % chunk)).reshape(-1, chunk)
    scale = np.maximum(np.abs(fp).max(1, keepdims=True) / np.float32(127.0),
                       np.float32(1e-12))
    return (fp / scale).reshape(-1)[:n].reshape(x.shape)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["plain", "int8"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_steps_match_jax(arch, compressed):
    """Each of 3 AdamW steps from the reference's state before it: loss,
    ``ce``, ``aux`` and ``grad_norm`` within 1e-5 relative, every param
    within 1e-5 of the largest, stacked as the reference's.  Two kinds of
    element may differ, at most one in 1000 of them together:

    * one whose grads so far stay, by their RMS (the reference's second
      moment after the step), within the grads' parity tolerance (1e-5) of
      the largest RMS: AdamW divides such a grad by its own size, so a
      difference at the tolerance moves the update by up to the rate;
    * compressed, one whose grad sits within 1e-3 of a .5 boundary of the
      int8 grid (the packages' grads differ in the last fp32 places and
      may round to neighbouring codes)."""
    from repro_torch.optim.compression import (Int8Compressor,
                                               StatelessRoundTrip)
    steps, final = _jax_family_run(arch, compressed)
    _, cfg = _family_cfgs(arch)
    o = opt.AdamW(learning_rate=FAMILY_LR)
    step = loop.build_train_step(cfg, o,
                                 loop.TrainStepConfig(compression=(
                                     StatelessRoundTrip(Int8Compressor())
                                     if compressed else None)))
    for i, (before, batch, jm, jgrads) in enumerate(steps):
        new, m = step(_port_lm_state(before), _torch_batch(batch))
        assert int(m["step"]) == i and int(new.step) == i + 1
        for k in ("loss", "ce", "aux", "grad_norm"):
            if jm[k] == 0.0:
                assert m[k].item() == 0.0
            else:
                assert _rel(m[k].item(), jm[k]) < TOL, k
        got = [x.numpy() for x in
               tree_leaves(loop.stack_blocks(new.params, cfg))]
        after = steps[i + 1][0] if i + 1 < len(steps) else final
        want = jax.tree_util.tree_leaves(after.params)
        assert [g.shape for g in got] == [w.shape for w in want]
        scale = max(float(np.max(np.abs(w))) for w in want)
        rms = [np.sqrt(v / (1.0 - o.b2 ** (i + 1)))
               for v in jax.tree_util.tree_leaves(after.opt_state.nu)]
        small = TOL * max(float(np.max(r)) for r in rms)
        n_far = 0
        for g, w, jg, r in zip(got, want, jgrads or rms, rms):
            far = np.abs(g - w) > TOL * scale
            n_far += int(far.sum())
            far &= r >= small
            if compressed:
                v = _int8_grid(jg)
                far &= ~(np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-3)
            assert not np.any(far)
        assert n_far <= 1e-3 * sum(w.size for w in want)
