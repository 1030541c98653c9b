"""The port's elastic restore (``repro_torch.checkpoint.elastic`` and
``Checkpointer.restore(shardings=...)``) against ``repro.checkpoint.elastic``.

Shardings from logical specs are held leaf by leaf to the reference's
``reshard_specs`` on the same abstract meshes (the reference's stacked
"layers" axis stripped, as the port keeps per-layer lists); a checkpoint of a
reduced model restores onto a two-rank gloo mesh (in subprocesses: no process
group is left in the test's), each rank's shard its slice of the saved
array; and the data remap is the reference's.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import elastic as jax_elastic
from repro.configs import get_reduced as jax_get_reduced
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.distributed import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.train import loop as jax_loop
from repro_torch.checkpoint import elastic
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.optim.optimizer import AdamW
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRIDS = [((2, 4), ("data", "model")), ((1, 2), ("data", "model")),
         ((2, 2, 2), ("pod", "data", "model")), ((4, 1), ("data", "model"))]


def _leaves(port, ref, stacked=False, path=""):
    """(path, port sharding, reference sharding, stacked) leaf by leaf."""
    if isinstance(port, sh.NamedSharding):
        yield path, port, ref, stacked
    elif isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            yield from _leaves(port[k], ref[k], stacked, f"{path}/{k}")
    elif isinstance(ref, dict):
        for i, sub in enumerate(port):
            yield from _leaves(sub, ref, True, f"{path}/{i}")
    else:
        for i, sub in enumerate(port):
            yield from _leaves(sub, ref[i], stacked, f"{path}/{i}")


@pytest.mark.parametrize("arch", ["smollm-135m", "dlrm-mlp", "whisper-tiny",
                                  "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("grid", GRIDS,
                         ids=["x".join(map(str, g)) for g, _ in GRIDS])
def test_reshard_specs_equal_the_reference(arch, grid):
    shape, names = grid
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    am = mesh_mod.make_abstract_mesh(shape, names)
    jm = jax_abstract_mesh(shape, names)
    rules = sh.gqa_safe_rules(cfg.n_kv_heads, am)
    with jax_sharding.use_sharding(jax_make_mesh((1,) * len(names), names),
                                   jax_sharding.gqa_safe_rules(
                                       jcfg.n_kv_heads, jm)) as jrules:
        want = jax_elastic.reshard_specs(jax_loop.model_param_specs(jcfg),
                                         jax_specs.abstract_params(jcfg), jm,
                                         rules=dict(jrules))
    with sh.use_sharding(am, rules) as prules:
        got = elastic.reshard_specs(loop.model_param_specs(cfg),
                                    specs.abstract_params(cfg), am,
                                    rules=prules)
    n = 0
    for path, mine, ref, stacked in _leaves(got, want):
        spec = tuple(ref.spec) + (None,) * (
            len(mine.spec) + stacked - len(tuple(ref.spec)))
        assert mine.spec == spec[stacked:], (path, mine.spec, spec)
        assert mine.mesh is am
        n += 1
    assert n == len(tree_leaves(specs.abstract_params(cfg)))


def test_remap_data_configs_equals_the_reference():
    for old_hosts, new_hosts in ((4, 2), (1, 4), (2, 8)):
        old = DataConfig(global_batch=16, n_hosts=old_hosts, host_id=0)
        jold = JaxDataConfig(global_batch=16, n_hosts=old_hosts, host_id=0)
        got = elastic.remap_data_configs(old, new_hosts)
        want = jax_elastic.remap_data_configs(jold, new_hosts)
        assert [vars(c) for c in got] == [vars(c) for c in want]
        assert [c.host_batch for c in got] == [16 // new_hosts] * new_hosts
    with pytest.raises(ValueError, match="must divide"):
        elastic.remap_data_configs(DataConfig(global_batch=10), 4)


def test_restore_on_a_one_device_mesh_keeps_local_tensors(tmp_path):
    """A mesh of one device places nothing: the restored tree is the saved
    one, tensor for tensor, and no tensor is a DTensor."""
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    params = loop.init_train_state(torch.Generator().manual_seed(3), cfg,
                                   AdamW(), device="cpu").params
    ck = Checkpointer(str(tmp_path))
    ck.save(7, params)
    with mesh_mod.open_mesh((1, 1), ("data", "model"), device="cpu") as mesh:
        got, step = elastic.restore_on_mesh(ck, params,
                                            loop.model_param_specs(cfg), mesh)
    assert step == 7
    flat_got = tree_leaves(got)
    for a, b in zip(tree_leaves(params), flat_got):
        assert type(b) is torch.Tensor and torch.equal(a, b)


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from repro_torch.checkpoint import elastic
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.optimizer import AdamW
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

rank, init, root, dims = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dims = tuple(int(d) for d in dims.split("x"))
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2)
cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
like = loop.init_train_state(torch.Generator().manual_seed(0), cfg, AdamW(),
                             device="cpu").params
mesh = make_mesh(dims, ("data", "model"), device="cpu")
restored, step = elastic.restore_on_mesh(
    Checkpointer(root), like, loop.model_param_specs(cfg), mesh)
saved = dict(np.load(root + "/full.npz"))
ok, sharded = [], 0
for i, (x, full) in enumerate(zip(tree_leaves(restored), saved.values())):
    assert isinstance(x, DTensor), type(x)
    want = torch.from_numpy(full)
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            r = mesh.get_local_rank(mdim)
            want = want.chunk(n, dim=p.dim)[r]
            sharded += n > 1
    ok.append(bool(torch.equal(x.to_local(), want)))
np.savez(root + f"/rank{rank}.npz", ok=np.array(ok), sharded=sharded,
         step=step)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("dims", ["1x2", "2x1"])
def test_restore_onto_a_two_rank_gloo_mesh_slices_each_rank(tmp_path, dims):
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    params = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   AdamW(), device="cpu").params
    for i, x in enumerate(tree_leaves(params)):
        x.add_(torch.arange(x.numel(), dtype=x.dtype).reshape(x.shape) * 1e-3
               + i)
    Checkpointer(str(tmp_path)).save(5, params)
    np.savez(tmp_path / "full.npz",
             **{f"{i:03d}": x.numpy() for i, x in
                enumerate(tree_leaves(params))})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "init"),
         str(tmp_path), dims], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["step"]) == 5
        assert got["ok"].all() and got["ok"].size == len(
            tree_leaves(params))
        # 1x2 shards the projections over the model axis; 2x1 the data
        # axis carries no param spec, so every leaf is whole there
        assert (int(got["sharded"]) > 0) == (dims == "1x2")
