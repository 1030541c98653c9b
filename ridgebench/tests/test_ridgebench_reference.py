"""The plain reference against the port's plain path on the CPU, at
reduced sizes, both in float32 (so they agree to rounding)."""
import pytest
import torch

from repro_torch.models import transformer

from ridgebench import weights
from ridgebench.model import model_config
from ridgebench.reference import lm as ref_lm
from ridgebench.tests.small import small_doc

F32 = dict(compute_dtype=torch.float32, use_flash=False,
           use_kernel_matmul=False)


@pytest.mark.parametrize("config", ["qwen2-moe-a2.7b"])
def test_forward_matches_port_fp32(config):
    doc = small_doc(config)
    params = weights.draw(doc, 11, torch.device("cpu"))
    tokens = torch.randint(0, doc["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(1))
    got, _ = transformer.forward(params, tokens, model_config(doc, **F32))
    ref = torch.stack(list(ref_lm.row_blocks(params, tokens, doc,
                                             ref_lm.Arith("fp32"))))
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max())


def test_moe_follows_given_choices():
    """Following the reference's own choices changes nothing, and the
    routing gap of its own top k is 0; a worse expert shows as a gap."""
    doc = small_doc("qwen2-moe-a2.7b")
    params = weights.draw(doc, 12, torch.device("cpu"))
    tokens = torch.randint(0, doc["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(2))
    ar = ref_lm.Arith("fp32")
    own = ref_lm.Routing()
    a = ref_lm.hidden(params, tokens, doc, ar, routing=own)
    follow = ref_lm.Routing(follow=own.chosen)
    b = ref_lm.hidden(params, tokens, doc, ar, routing=follow)
    assert torch.equal(a, b) and follow.gap == 0.0
    worse = [c.flip(-1).clone() for c in own.chosen]
    worse[0][:, 0] = (worse[0][:, 0] + 3) % doc["num_experts"]
    bad = ref_lm.Routing(follow=worse)
    ref_lm.hidden(params, tokens, doc, ar, routing=bad)
    assert bad.gap > 0.1


def test_gates_follow_norm_topk_prob():
    """The file's ``norm_topk_prob`` decides whether the k gates are
    renormalised: unrenormalised, an MoE layer's routed output shrinks."""
    doc = small_doc("qwen2-moe-a2.7b")
    params = weights.draw(doc, 14, torch.device("cpu"))
    x = torch.randn(2, 32, doc["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    p = dict(params["blocks"][0]["moe"])
    p["shared"] = {k: torch.zeros_like(v) for k, v in p["shared"].items()}
    ar = ref_lm.Arith("fp32")
    norm = ref_lm.moe(p, x, doc, ar)
    plain = ref_lm.moe(p, x, dict(doc, norm_topk_prob=False), ar)
    assert plain.norm() < norm.norm()


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path
    root = Path(ref_lm.__file__).parent
    for path in root.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax", "ridgebench"
                                   ) or n.startswith("ridgebench.reference"), \
                    (path.name, n)
