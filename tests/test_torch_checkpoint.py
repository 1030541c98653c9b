"""The port's checkpointer: the cases of ``tests/test_checkpoint.py`` on the
port, the leaves numpy cannot hold as they are (bf16, a generator's state),
snapshot semantics of an async save, the manifest against the JAX
checkpointer's for the same train state, checkpoints crossing between the
packages both ways, and a bitwise resume of reduced smollm-135m.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import get_reduced as jax_get_reduced
from repro.optim import optimizer as jax_opt
from repro.train import loop as jax_loop
from repro_torch.checkpoint.checkpointer import (COMMIT_MARKER,
                                                 CheckpointCorruptionError,
                                                 Checkpointer)
from repro_torch.configs import get_reduced
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.optim.optimizer import AdamW
from repro_torch.train.loop import (TrainStepConfig, build_train_step,
                                    init_train_state, stack_blocks,
                                    unstack_blocks)
from repro_torch.tree import tree_leaves


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _assert_equal(want, got):
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _manifest(root, step):
    with open(os.path.join(str(root), f"step_{step:09d}",
                           "manifest.json")) as f:
        return json.load(f)


class TestRoundtrip:
    def test_save_restore_identical(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        t = _tree()
        ck.save(7, t)
        restored, step = ck.restore(t)
        assert step == 7
        _assert_equal(t, restored)

    def test_async_save(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(), async_=True)
        ck.wait()
        assert ck.latest_step() == 1

    def test_uncommitted_checkpoint_ignored(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        ck.save(2, _tree())
        os.remove(os.path.join(str(tmp_path), "step_000000002", COMMIT_MARKER))
        assert ck.latest_step() == 1
        _, step = ck.restore(_tree())
        assert step == 1

    def test_keep_n_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, _tree())
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                       if n.startswith("step_"))
        assert steps == [3, 4]

    def test_restore_missing_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            ck.restore(_tree())

    def test_shardings_wait_for_the_mesh(self, tmp_path):
        """Restoring onto a mesh is ported: a None sharding keeps the leaf,
        and a mesh of one device keeps every leaf local."""
        from repro_torch.distributed.sharding import NamedSharding
        from repro_torch.launch.mesh import make_abstract_mesh
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        got, step = ck.restore(_tree(), shardings={"a": None})
        assert step == 1 and torch.equal(got["a"], _tree()["a"])
        one = NamedSharding(make_abstract_mesh((1, 1), ("data", "model")),
                            ("data",))
        got, _ = ck.restore(_tree(), shardings={"a": one})
        assert type(got["a"]) is torch.Tensor
        assert torch.equal(got["a"], _tree()["a"])

    def test_wrong_structure_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        with pytest.raises(ValueError, match="3 leaves, expected 1"):
            ck.restore({"a": torch.zeros(3, 4)})


class TestIntegrity:
    """Corruption of *committed* checkpoints: detect, quarantine, fall back."""

    def _shard(self, root, step):
        d = os.path.join(str(root), f"step_{step:09d}")
        name = next(n for n in sorted(os.listdir(d))
                    if n.startswith("shard_"))
        return os.path.join(d, name)

    def test_truncated_shard_skipped_by_latest_step(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        ck.save(2, _tree())
        with open(self._shard(tmp_path, 2), "w"):
            pass                              # truncate to zero bytes
        assert ck.latest_step() == 1
        _, step = ck.restore(_tree())
        assert step == 1

    def test_bitflip_quarantined_and_fallback(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        ck.save(2, _tree())
        path = self._shard(tmp_path, 2)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:          # silent bitrot mid-file
            f.seek(size // 2)
            f.write(b"\xff\x00\xff\x00")
        assert ck.latest_step() == 2          # cheap scan cannot see it
        restored, step = ck.restore(_tree())
        assert step == 1                      # crc32 caught it, fell back
        _assert_equal(_tree(), restored)
        assert any(".quarantined_" in n for n in os.listdir(tmp_path))
        assert ck.latest_step() == 1

    def test_explicit_corrupt_step_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        ck.save(2, _tree())
        with open(self._shard(tmp_path, 2), "r+b") as f:
            f.write(b"\x00\x00\x00\x00")
        with pytest.raises(CheckpointCorruptionError):
            ck.restore(_tree(), step=2)

    def test_all_corrupt_raises_not_loops(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        with open(self._shard(tmp_path, 1), "r+b") as f:
            f.write(b"\x00\x00\x00\x00")
        with pytest.raises(FileNotFoundError):
            ck.restore(_tree())

    def test_quarantined_dirs_do_not_break_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        ck.save(1, _tree())
        with open(self._shard(tmp_path, 1), "r+b") as f:
            f.write(b"\x00\x00\x00\x00")
        with pytest.raises(FileNotFoundError):
            ck.restore(_tree())               # quarantines step 1
        for s in (2, 3, 4):
            ck.save(s, _tree())
        assert ck.latest_step() == 4

    def test_checksums_recorded_in_manifest(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(5, _tree())
        meta = _manifest(tmp_path, 5)
        assert meta["checksums"]
        for name in meta["checksums"]:
            assert os.path.exists(os.path.join(str(tmp_path),
                                               "step_000000005", name))


# ---- leaves numpy cannot hold as they are ------------------------------------

def test_bf16_and_generator_round_trip_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(7, generator=gen)             # move it off its seed
    # bf16 values no fp32 -> bf16 cast of a numpy fp32 would give back:
    # every bit pattern of a high byte, NaN payloads included
    bits = torch.arange(-32768, 32768, 97, dtype=torch.int32).to(torch.int16)
    tree = {"w": bits.view(torch.bfloat16), "rng": gen,
            "none": None, "step": torch.tensor(3, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    meta = _manifest(tmp_path, 1)
    assert meta["n_leaves"] == 3              # None gives no leaf, as in jax
    assert meta["dtypes"][2] == "bfloat16"
    like = {"w": torch.zeros(len(bits), dtype=torch.bfloat16),
            "rng": torch.Generator(), "none": None,
            "step": torch.tensor(0, dtype=torch.int32)}
    got, _ = ck.restore(like)
    assert got["none"] is None
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), bits)
    assert got["rng"] is not like["rng"]
    assert torch.equal(got["rng"].get_state(), gen.get_state())
    assert torch.equal(torch.rand(5, generator=got["rng"]),
                       torch.rand(5, generator=gen))


def test_async_save_snapshots_the_moment_of_the_call(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = {"a": torch.arange(1 << 20, dtype=torch.float32)}
    want = t["a"].clone()
    ck.save(1, t, async_=True)
    t["a"].mul_(-1.0)                        # the caller goes on at once
    ck.wait()
    got, _ = ck.restore({"a": torch.zeros(1 << 20)})
    assert torch.equal(got["a"], want)


# ---- the same state in both packages -----------------------------------------

def _jax_mlp_state():
    jcfg = jax_get_reduced("dlrm-mlp").replace(compute_dtype=jnp.float32)
    jo = jax_opt.AdamW(learning_rate=1e-3)
    return jax_loop.init_train_state(jax.random.PRNGKey(4), jcfg, jo)


def _port_mlp_state(jstate):
    from repro_torch.convert import train_state_from_numpy
    return train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu",
        generator=torch.Generator().manual_seed(4))


def test_manifest_matches_the_jax_checkpointer(tmp_path):
    """Leaf count, order, shapes and dtypes of a ``TrainState`` (params, the
    AdamW state's step, mu and nu, step, rng): the reference's, leaf for
    leaf, but for the rng (a JAX key there, a generator's bytes here)."""
    jstate = _jax_mlp_state()
    JaxCheckpointer(str(tmp_path / "jax")).save(1, jstate)
    Checkpointer(str(tmp_path / "port")).save(1, _port_mlp_state(jstate))
    want, got = _manifest(tmp_path / "jax", 1), _manifest(tmp_path / "port", 1)
    assert got["n_leaves"] == want["n_leaves"]
    assert got["shapes"][:-1] == want["shapes"][:-1]
    assert got["dtypes"][:-1] == want["dtypes"][:-1]
    assert want["dtypes"][-1] == "uint32" and got["dtypes"][-1] == "uint8"
    assert got["treedef"].startswith("TrainState(params={'head'")
    for k in ("n_hosts", "step"):
        assert got[k] == want[k]
    assert list(got["checksums"]) == list(want["checksums"])


def test_params_cross_between_the_packages(tmp_path):
    jparams = _jax_mlp_state().params
    params = mlp_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    JaxCheckpointer(str(tmp_path / "jax")).save(3, jparams)
    got, step = Checkpointer(str(tmp_path / "jax")).restore(
        jax.tree_util.tree_map(torch.zeros_like, params))
    assert step == 3
    _assert_equal(params, got)

    moved = jax.tree_util.tree_map(lambda x: x * 2.0 + 1.0, params)
    Checkpointer(str(tmp_path / "port")).save(4, moved)
    back, step = JaxCheckpointer(str(tmp_path / "port")).restore(jparams)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(moved)):
        assert np.array_equal(np.asarray(a), b.numpy())


# ---- restart determinism -----------------------------------------------------

def test_bitwise_resume(tmp_path):
    """train(6) == train(3) -> save -> restore -> train(3), bit for bit,
    params, AdamW moments, counters and the generator."""
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    opt = AdamW(learning_rate=1e-2)
    step_fn = build_train_step(cfg, opt, TrainStepConfig())
    stream = make_stream(cfg, DataConfig(seed=5, global_batch=2, seq_len=16))

    def run(state, lo, hi):
        for s in range(lo, hi):
            state, _ = step_fn(state, to_device(stream.batch(s), "cpu"))
        return state

    def fresh():
        return init_train_state(torch.Generator().manual_seed(3), cfg, opt,
                                device="cpu")

    straight = run(fresh(), 0, 6)
    ck = Checkpointer(str(tmp_path))
    half = run(fresh(), 0, 3)
    ck.save(3, half)
    restored, step = ck.restore(fresh())
    assert step == 3 and int(restored.step) == 3
    assert torch.equal(restored.rng.get_state(), half.rng.get_state())
    resumed = run(restored, step, 6)
    for a, b in zip(tree_leaves([straight.params, straight.opt_state.mu,
                                 straight.opt_state.nu]),
                    tree_leaves([resumed.params, resumed.opt_state.mu,
                                 resumed.opt_state.nu])):
        assert torch.equal(a, b)
    assert int(resumed.opt_state.step) == int(straight.opt_state.step) == 6


# ---- every family in the reference's layout ------------------------------------

FAMILY_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m",
                "whisper-tiny", "internvl2-26b")


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    jcfg = jax_get_reduced(arch).replace(compute_dtype=jnp.float32)
    jo = jax_opt.AdamW(learning_rate=1e-3)
    return jax.tree_util.tree_map(np.asarray, jax_loop.init_train_state(
        jax.random.PRNGKey(4), jcfg, jo))


def _port_params(tree, cfg):
    from repro_torch import convert
    fn = {"encdec": convert.encdec_params_from_numpy,
          "vlm": convert.vlm_params_from_numpy}.get(
              cfg.family, convert.lm_params_from_numpy)
    return fn(tree, device="cpu")


def _port_state(jstate, cfg):
    """The reference's numpy ``TrainState`` in the port's layout (per-layer
    lists), AdamW's moments too."""
    from repro_torch.optim.optimizer import AdamWState
    from repro_torch.train.loop import TrainState
    o = jstate.opt_state
    return TrainState(
        _port_params(jstate.params, cfg),
        AdamWState(step=torch.tensor(int(o.step), dtype=torch.int32),
                   mu=_port_params(o.mu, cfg), nu=_port_params(o.nu, cfg)),
        torch.tensor(int(jstate.step), dtype=torch.int32),
        torch.Generator().manual_seed(4))


def _stacked_state(state, cfg):
    """``state`` with its params and moments in the reference's layout
    (``stack_blocks``: the scan-stacked blocks on a leading layer axis)."""
    from repro_torch.optim.optimizer import AdamWState
    o = state.opt_state
    return state._replace(
        params=stack_blocks(state.params, cfg),
        opt_state=AdamWState(o.step, stack_blocks(o.mu, cfg),
                             stack_blocks(o.nu, cfg)))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_manifest_matches_the_jax_checkpointer(arch, tmp_path):
    """Saved in the reference's layout (``stack_blocks``), the manifest of
    each family's state is the reference's leaf for leaf (count, shapes,
    dtypes, shards) but for the rng; restoring and ``unstack_blocks`` give
    the saved per-layer lists bit for bit."""
    cfg = get_reduced(arch)
    jstate = _jax_state(arch)
    state = _port_state(jstate, cfg)
    JaxCheckpointer(str(tmp_path / "jax")).save(1, jstate)
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(1, _stacked_state(state, cfg))
    want, got = _manifest(tmp_path / "jax", 1), _manifest(tmp_path / "port", 1)
    assert got["n_leaves"] == want["n_leaves"]
    assert got["shapes"][:-1] == want["shapes"][:-1]
    assert got["dtypes"][:-1] == want["dtypes"][:-1]
    assert list(got["checksums"]) == list(want["checksums"])
    back, step = ck.restore(_stacked_state(_port_state(jstate, cfg), cfg))
    assert step == 1
    _assert_equal([state.params, state.opt_state.mu, state.opt_state.nu],
                  [unstack_blocks(t, state.params) for t in
                   (back.params, back.opt_state.mu, back.opt_state.nu)])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b",
                                  "xlstm-125m"])
def test_family_params_cross_between_the_packages(arch, tmp_path):
    """The reference's params restore into the port's per-layer lists (by
    ``unstack_blocks``), and the port's (moved off them, saved by
    ``stack_blocks``) restore into the reference's tree."""
    cfg = get_reduced(arch)
    jparams = _jax_state(arch).params
    params = _port_params(jparams, cfg)
    JaxCheckpointer(str(tmp_path / "jax")).save(3, jparams)
    got, step = Checkpointer(str(tmp_path / "jax")).restore(stack_blocks(
        jax.tree_util.tree_map(torch.zeros_like, params), cfg))
    assert step == 3
    _assert_equal(params, unstack_blocks(got, params))

    moved = stack_blocks(
        jax.tree_util.tree_map(lambda x: x * 2.0 + 1.0, params), cfg)
    Checkpointer(str(tmp_path / "port")).save(4, moved)
    back, step = JaxCheckpointer(str(tmp_path / "port")).restore(jparams)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(moved)):
        assert np.array_equal(np.asarray(a), b.numpy())
