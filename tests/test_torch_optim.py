"""The port's optimizers against ``repro.optim.optimizer``, on the CPU.

Both packages get the same numpy params and the same numpy grads at every
step; a mid-run case first runs the JAX optimizer a few steps and hands
its state to the port through ``convert.opt_state_from_numpy``, so the
bias corrections and the schedule are past step 1.  fp32 throughout:
params, states and updates agree within 1e-6 of the tree's largest value.
The arithmetic is the same; the global norm's sum runs in another order
(one ulp), and in a one-element leaf (the head bias) a moment that nearly
cancels turns that ulp into ~1e-6 of the leaf itself, so the scale is the
whole tree's, not each leaf's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jax_opt
from repro_torch.convert import opt_state_from_numpy
from repro_torch.optim import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-6


def _tree(rng, scale=1.0):
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"layers": [{"w": a(8, 6), "b": a(6)}, {"w": a(6, 6), "b": a(6)}],
            "head": {"w": a(6, 1), "b": a(1)}}


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_close(got, want, tol=TOL):
    got_l = [np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                        np.float32) for x in tree_leaves(got)]
    want_l = [np.asarray(x, np.float32)
              for x in jax.tree_util.tree_leaves(want)]
    assert [g.shape for g in got_l] == [w.shape for w in want_l]
    scale = max(float(np.max(np.abs(w))) for w in want_l)
    err = max(float(np.max(np.abs(g - w))) for g, w in zip(got_l, want_l))
    assert err < tol * max(scale, 1e-30), err / scale


def _pair(kind, lr, clip):
    """The JAX and the port's optimizer, alike: a constant rate or a
    warmup-cosine schedule; the default clip or ``clip``."""
    kw = {} if clip is None else {"clip_norm": clip}
    peak = 3e-3 if kind == "adamw" else 3e-2
    jcls, tcls = ((jax_opt.AdamW, opt.AdamW) if kind == "adamw"
                  else (jax_opt.SGD, opt.SGD))
    if lr == "const":
        return jcls(learning_rate=peak, **kw), tcls(learning_rate=peak, **kw)
    return (jcls(learning_rate=jax_opt.warmup_cosine(peak, 4, 20), **kw),
            tcls(learning_rate=opt.warmup_cosine(peak, 4, 20), **kw))


def _grads(seed, n):
    rng = np.random.default_rng(100 + seed)
    # large enough that a 1.0 clip bites on some steps
    return [_tree(rng, scale=0.4) for _ in range(n)]


def _state_leaves(state):
    return [state.mu, state.nu] if hasattr(state, "mu") else [state.momentum]


@pytest.mark.parametrize("start", ["fresh", "mid_run"])
@pytest.mark.parametrize("clip", [None, 0.0, 0.5], ids=["clip_default",
                                                         "no_clip", "clip0.5"])
@pytest.mark.parametrize("lr", ["const", "cosine"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_k_steps_match_jax(kind, lr, clip, start):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    j, t = _pair(kind, lr, clip)
    jp, jstate = _to_jax(params), j.init(_to_jax(params))
    if start == "mid_run":
        for g in _grads(1, 3):
            upd, jstate = j.update(_to_jax(g), jstate, jp)
            jp = jax_opt.apply_updates(jp, upd)
        tstate = opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
        tp = _to_torch(jax.tree_util.tree_map(np.asarray, jp))
        assert int(tstate.step) == 3
    else:
        tstate, tp = t.init(_to_torch(params)), _to_torch(params)
    for g in _grads(2, 3):
        jupd, jstate = j.update(_to_jax(g), jstate, jp)
        tupd, tstate = t.update(_to_torch(g), tstate, tp)
        _assert_close(tupd, jupd)
        jp = jax_opt.apply_updates(jp, jupd)
        tp = opt.apply_updates(tp, tupd)
        _assert_close(tp, jp)
        for got, want in zip(_state_leaves(tstate), _state_leaves(jstate)):
            _assert_close(got, want)
        assert int(tstate.step) == int(jstate.step)


def test_state_is_fp32_and_updates_take_the_param_dtype():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "b": torch.ones((4,), dtype=torch.float32)}
    grads = tree_map(lambda p: torch.full(p.shape, 0.5, dtype=p.dtype),
                     params)
    for o in (opt.AdamW(), opt.SGD()):
        state = o.init(params)
        assert all(x.dtype == torch.float32 for x in tree_leaves(
            _state_leaves(state)))
        assert state.step.dtype == torch.int32 and int(state.step) == 0
        upd, state = o.update(grads, state, params)
        assert upd["w"].dtype == torch.bfloat16
        assert upd["b"].dtype == torch.float32
        assert int(state.step) == 1


def test_first_update_uses_the_incremented_step():
    """warmup_cosine is 0 at step 0; the first update takes lr(1)."""
    sched = opt.warmup_cosine(1e-2, 10, 100)
    assert float(sched(torch.tensor(0))) == 0.0
    p = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 2.0)}
    sgd = opt.SGD(learning_rate=sched, momentum=0.0)
    upd, _ = sgd.update(g, sgd.init(p), p)
    assert torch.allclose(upd["w"], torch.full((3,), -1e-3 * 2.0))
    # AdamW's first bias-corrected step is sign(g): lr(1) (1 + wd·p)
    adam = opt.AdamW(learning_rate=sched, clip_norm=0.0)
    upd, _ = adam.update(g, adam.init(p), p)
    assert torch.allclose(upd["w"], torch.full((3,), -1e-3 * (1 + 0.1)),
                          rtol=1e-6)


def test_clip_is_inside_update_and_on_by_default():
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 10.0)}             # norm 20
    adam = opt.AdamW(learning_rate=1.0, b1=0.0, b2=0.0, eps=0.0,
                     weight_decay=0.0)
    assert adam.clip_norm == 1.0
    _, state = adam.update(g, adam.init(p), p)
    assert torch.allclose(state.mu["w"], torch.full((4,), 0.5))   # 10 / 20
    sgd = opt.SGD(learning_rate=1.0, momentum=0.9)
    _, state = sgd.update(g, sgd.init(p), p)      # SGD does not clip
    assert torch.equal(state.momentum["w"], g["w"])
    _, state = sgd.update(g, state, p)            # μ·m + g, no dampening
    assert torch.allclose(state.momentum["w"], torch.full((4,), 19.0))


def test_adamw_defaults_equal_reference():
    assert (opt.AdamW().b1, opt.AdamW().b2, opt.AdamW().eps,
            opt.AdamW().weight_decay, opt.AdamW().clip_norm) == \
        (jax_opt.AdamW().b1, jax_opt.AdamW().b2, jax_opt.AdamW().eps,
         jax_opt.AdamW().weight_decay, jax_opt.AdamW().clip_norm) == \
        (0.9, 0.95, 1e-8, 0.1, 1.0)
    assert (opt.SGD().learning_rate, opt.SGD().momentum,
            opt.SGD().clip_norm) == (jax_opt.SGD().learning_rate,
                                     jax_opt.SGD().momentum,
                                     jax_opt.SGD().clip_norm)


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 12, 20, 50])
def test_warmup_cosine_matches_jax(step):
    got = opt.warmup_cosine(3e-3, 4, 20)(torch.tensor(step, dtype=torch.int32))
    want = jax_opt.warmup_cosine(3e-3, 4, 20)(jnp.int32(step))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= TOL * 3e-3


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3))
    got = float(opt.global_norm(_to_torch(tree)))
    want = float(jax_opt.global_norm(_to_jax(tree)))
    assert abs(got - want) <= TOL * want


def test_opt_state_from_numpy_rejects_other_states():
    with pytest.raises(ValueError, match="AdamW or SGD"):
        opt_state_from_numpy({"step": 0, "count": {}}, device="cpu")
