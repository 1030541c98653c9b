"""The port's gradient compression against ``repro.optim.compression``.

Int8 and top-k ``round_trip_tree`` over 3 steps of error feedback (the
residual carried from step to step) on the same numpy grads, with a leaf the
chunk does not divide and planted ties: .5 on the int8 grid (a chunk whose
max is 127, so the scale is 1 and ``round`` meets exact halves, which both
round to even) and equal magnitudes at the top-k threshold (``>=`` keeps
all of them).  Dequantized grads and residuals agree within 1e-6 of the
largest value.  Then a reduced smollm-135m fp32 train step with
``StatelessRoundTrip`` against the reference's jitted step, from one state:
the reference compresses its scan-stacked block leaves, so the port's step
compresses its per-layer grads stacked the same way (``stack_blocks``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.optim import compression as jax_comp
from repro.optim import optimizer as jax_opt
from repro.train import loop as jax_loop
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.optim import compression as comp
from repro_torch.optim import optimizer as opt
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

TOL = 1e-6


def _grads(step):
    """A tree of numpy grads: a tied leaf, a leaf no chunk divides, a matrix."""
    rng = np.random.default_rng(100 + step)
    ties = np.concatenate([[127.0, -127.0], rng.integers(-60, 60, 62) + 0.5])
    return {"ties": ties.astype(np.float32),
            "ragged": rng.standard_normal(5000).astype(np.float32),
            "w": {"mat": rng.standard_normal((37, 29)).astype(np.float32)}}


def _err(got_tree, want_tree):
    got = [x.numpy() for x in tree_leaves(got_tree)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want_tree)]
    assert [g.shape for g in got] == [w.shape for w in want]
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))


def _largest(tree):
    return max(float(np.max(np.abs(np.asarray(x)))) for x in tree_leaves(tree))


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("make", [
    lambda m: m.Int8Compressor(chunk=64), lambda m: m.Int8Compressor(),
    lambda m: m.TopKCompressor(keep=0.1), lambda m: m.TopKCompressor()],
    ids=["int8_chunk64", "int8_chunk4096", "topk_0.1", "topk_0.01"])
def test_round_trip_tree_with_error_feedback(make, jit):
    """Against the eager reference the port is bitwise; XLA's fused program
    may contract ``x - q * scale`` into one FMA, a last-place difference of
    x's size, so against the jitted one the tolerance is TOL of the largest
    grad (x = g + r)."""
    want_c, got_c = make(jax_comp), make(comp)
    want_fn = (jax.jit(want_c.round_trip_tree) if jit
               else want_c.round_trip_tree)
    want_state = want_c.init(jax.tree_util.tree_map(jnp.asarray, _grads(0)))
    got_state = got_c.init(_torch(_grads(0)))
    for step in range(3):
        g = _grads(step)
        want, want_state = want_fn(
            jax.tree_util.tree_map(jnp.asarray, g), want_state)
        got, got_state = got_c.round_trip_tree(_torch(g), got_state)
        tol = TOL * _largest(_torch(g)) if jit else 0.0
        assert _err(got, want) <= tol
        assert _err(got_state.residual, want_state.residual) <= tol
    # error feedback: what was not sent is carried to the next step
    assert _largest(got_state.residual) > 0.0


def test_int8_ties_round_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5])
    deq, state = comp.Int8Compressor(chunk=6).round_trip_tree(
        {"x": x}, comp.CompressorState(residual={"x": torch.zeros(6)}))
    assert deq["x"].tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -4.0]
    assert state.residual["x"].tolist() == [0.0, 0.5, -0.5, 0.5, -0.5, 0.5]


def test_topk_keeps_every_tie_at_the_threshold():
    x = torch.tensor([3.0, -2.0, 2.0, 1.0, 2.0, 0.5, 0.1, 0.0, -0.2, 0.3])
    deq, _ = comp.TopKCompressor(keep=0.2).round_trip_tree(
        {"x": x}, comp.TopKCompressor().init({"x": x}))
    assert deq["x"].tolist() == [3.0, -2.0, 2.0, 0.0, 2.0] + [0.0] * 5


@pytest.mark.parametrize("chunk", [64, 4096])
def test_compress_matches_reference(chunk):
    g = _grads(1)["ragged"]
    r = _grads(2)["ragged"] * 0.01
    wq, ws, wr = jax_comp.Int8Compressor(chunk=chunk).compress(
        jnp.asarray(g), jnp.asarray(r))
    q, s, res = comp.Int8Compressor(chunk=chunk).compress(
        torch.from_numpy(g), torch.from_numpy(r))
    assert q.dtype == torch.int8 and q.shape == wq.shape
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert np.array_equal(s.numpy(), np.asarray(ws))
    assert np.max(np.abs(res.numpy() - np.asarray(wr))) <= TOL * np.max(
        np.abs(g))


@pytest.mark.parametrize("make", [
    lambda m: m.Int8Compressor(), lambda m: m.Int8Compressor(chunk=64),
    lambda m: m.TopKCompressor(), lambda m: m.TopKCompressor(keep=0.25)])
def test_wire_fraction(make):
    assert make(comp).wire_fraction == make(jax_comp).wire_fraction


def test_stateless_round_trip_is_one_step_from_zero():
    g = _torch(_grads(0))
    want, _ = comp.Int8Compressor().round_trip_tree(
        g, comp.Int8Compressor().init(g))
    got = comp.StatelessRoundTrip(comp.Int8Compressor()).round_trip(g)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


# ---- the train step with compression -----------------------------------------

LR = 1e-2
CHUNK = comp.Int8Compressor().chunk


@functools.lru_cache(maxsize=None)
def _jax_run():
    """Reduced smollm-135m, fp32: the reference's state before each of 3
    jitted steps with StatelessRoundTrip(Int8Compressor()), the batch each
    step took, its loss and its stacked grads (before compression), and the
    state after the last step; all numpy."""
    jcfg = jax_get_reduced("smollm-135m").replace(compute_dtype=jnp.float32)
    jo = jax_opt.AdamW(learning_rate=LR)
    step = jax.jit(jax_loop.build_train_step(jcfg, jo, jax_loop.TrainStepConfig(
        compression=jax_comp.StatelessRoundTrip(jax_comp.Int8Compressor()))))
    grad_fn = jax.jit(jax.value_and_grad(jax_loop.make_loss_fn(jcfg),
                                         has_aux=True))
    state = jax_loop.init_train_state(jax.random.PRNGKey(1), jcfg, jo)
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        _, grads = grad_fn(state.params, jb)
        before = jax.tree_util.tree_map(np.asarray, state)
        state, m = step(state, jb)
        steps.append((before, batch, float(m["loss"]),
                      jax.tree_util.tree_map(np.asarray, grads)))
    return steps, jax.tree_util.tree_map(np.asarray, state)


def _port_state(jstate):
    """The reference's ``TrainState`` (numpy) in the port's layout."""
    mu, nu = jstate.opt_state.mu, jstate.opt_state.nu
    lm = functools.partial(lm_params_from_numpy, device="cpu")
    step = torch.tensor(int(jstate.step), dtype=torch.int32)
    return loop.TrainState(lm(jstate.params), opt.AdamWState(
        step=torch.tensor(int(jstate.opt_state.step), dtype=torch.int32),
        mu=lm(mu), nu=lm(nu)), step, None)


def _int8_grid(x):
    """x on the int8 grid of its chunks: x / scale, before rounding."""
    n = x.size
    fp = np.pad(x.reshape(-1), (0, (-n) % CHUNK)).reshape(-1, CHUNK)
    scale = np.maximum(np.abs(fp).max(1, keepdims=True) / np.float32(127.0),
                       np.float32(1e-12))
    return (fp / scale).reshape(-1)[:n].reshape(x.shape)


def test_blocks_stack_into_the_reference_layout():
    """The compressor sees the grads as the reference holds them: its
    scan-stacked blocks, so an int8 chunk spans the same elements."""
    before = _jax_run()[0][0][0]
    cfg = get_reduced("smollm-135m")
    params = lm_params_from_numpy(before.params, device="cpu")
    stacked = loop.stack_blocks(params, cfg)
    want = jax.tree_util.tree_leaves(before.params)
    got = tree_leaves(stacked)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    back = loop.unstack_blocks(stacked, params)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(params)))
    # dlrm-mlp's layers are a list in both packages: nothing stacks
    mlp = {"layers": [{"w": torch.ones(2, 2)}] * 3}
    assert loop.stack_blocks(mlp, get_reduced("dlrm-mlp")) == mlp


def test_compressed_train_step_matches_reference():
    """Each of 3 steps from the reference's state: the loss within 1e-5 and
    every param within 1e-5 of the largest, except where the grad sits
    within 1e-3 of a .5 boundary of the int8 grid.  There the two packages'
    grads, which differ in the last fp32 places (another summation order),
    may round to neighbouring codes; at most one element in 1000 differs
    so.  The port's own chain of 3 steps takes the reference's losses."""
    steps, final = _jax_run()
    cfg = get_reduced("smollm-135m").replace(compute_dtype=torch.float32)
    o = opt.AdamW(learning_rate=LR)
    step = loop.build_train_step(cfg, o, loop.TrainStepConfig(
        compression=comp.StatelessRoundTrip(comp.Int8Compressor())))
    chained = _port_state(steps[0][0])
    for i, (before, batch, jloss, jgrads) in enumerate(steps):
        b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        new, m = step(_port_state(before), b)
        assert abs(m["loss"].item() - jloss) <= 1e-5 * abs(jloss)
        chained, cm = step(chained, b)
        assert abs(cm["loss"].item() - jloss) <= 1e-5 * abs(jloss)

        got = [g.numpy() for g in
               tree_leaves(loop.stack_blocks(new.params, cfg))]
        want = jax.tree_util.tree_leaves(
            (steps[i + 1][0] if i + 1 < len(steps) else final).params)
        scale = max(float(np.max(np.abs(w))) for w in want)
        n_far = 0
        for g, w, v in zip(got, want, map(_int8_grid,
                                          jax.tree_util.tree_leaves(jgrads))):
            far = np.abs(g - w) > 1e-5 * scale
            on_boundary = np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-3
            assert not np.any(far & ~on_boundary)
            n_far += int(far.sum())
        assert n_far <= 1e-3 * sum(w.size for w in want)
