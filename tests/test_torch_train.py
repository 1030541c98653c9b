"""The port's mlp train step against ``repro.train.loop``, on the CPU.

``get_reduced("dlrm-mlp")`` (3 layers of 64) in fp32 compute, AdamW with a
warmup-cosine schedule: JAX's ``init_train_state`` makes the state, which
goes to the port through ``convert.train_state_from_numpy``, and both take
the same numpy batches.  After each of 3 steps the params, the loss and the
pre-clip ``grad_norm`` agree within 1e-5 relative (params: of the tree's
largest value), with ``n_micro`` 1 and 2, from step 0 and from a state
carried over at step 2.  A two-process gloo run checks the data-parallel
step, the collective benches and the calibrate CLI's two-rank path.
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


def test_other_families_and_compression_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 7"):
        loop.build_train_step(get_config("smollm-135m"), opt.AdamW())
    with pytest.raises(NotImplementedError, match="item 8"):
        loop.model_param_specs(get_config("qwen2-moe-a2.7b"))
    with pytest.raises(NotImplementedError, match="item 11"):
        loop.build_train_step(get_reduced("dlrm-mlp"), opt.AdamW(),
                              loop.TrainStepConfig(compression=object()))
    assert loop.model_param_specs(get_reduced("dlrm-mlp")) == \
        mlp_dlrm.mlp_specs(get_reduced("dlrm-mlp"))


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
