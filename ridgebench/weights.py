"""The benchmark's weights: drawn from the seed on the run's device, in the
port's parameter layout, as float32 (the dtype the port keeps them in).

One flat float32 buffer holds every leaf; it is filled by a few large
``normal_`` calls on one ``torch.Generator`` seeded with ``--seed``, and
each leaf, a view of it, is then scaled in place: a product's weight to
N(0, 1/fan_in), the embedding to N(0, 0.02^2), norm scales to
1 + N(0, 0.1^2), biases to N(0, 0.1^2).  The same seed gives the same
weights on the same device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements a ``normal_`` call draws at most
CHUNK = 1 << 28

Leaf = Tuple[Tuple, Tuple[int, ...], float, float]   # path, shape, mean, std


def _w(path, d_in: int, d_out: int) -> Leaf:
    return path, (d_in, d_out), 0.0, 1.0 / math.sqrt(d_in)


def _ones(path, *shape: int) -> Leaf:
    return path, shape, 1.0, 0.1


def _small(path, *shape: int) -> Leaf:
    return path, shape, 0.0, 0.1


def layout(doc: Dict) -> List[Leaf]:
    """Every leaf of the MoE configuration's parameter tree: (path, shape,
    mean, std); a path is dict keys with a block's index."""
    D, V = doc["hidden_size"], doc["vocab_size"]
    H, K = doc["num_attention_heads"], doc["num_key_value_heads"]
    dh = D // H
    if doc["port"]["family"] != "moe":
        raise ValueError(f"no weights for family {doc['port']['family']!r}")
    E, Fe = doc["num_experts"], doc["moe_intermediate_size"]
    Fs = doc["shared_expert_intermediate_size"]
    leaves: List[Leaf] = [(("embed",), (V, D), 0.0, 0.02)]
    for i in range(doc["num_hidden_layers"]):
        b = ("blocks", i)
        attn = [_w(b + ("attn", "wq"), D, H * dh),
                _w(b + ("attn", "wk"), D, K * dh),
                _w(b + ("attn", "wv"), D, K * dh),
                _w(b + ("attn", "wo"), H * dh, D)]
        if doc["port"].get("qkv_bias"):
            attn += [_small(b + ("attn", "bq"), H * dh),
                     _small(b + ("attn", "bk"), K * dh),
                     _small(b + ("attn", "bv"), K * dh)]
        m = b + ("moe",)
        leaves += [_ones(b + ("attn_norm", "scale"), D), *attn,
                   _ones(b + ("ffn_norm", "scale"), D),
                   _w(m + ("router",), D, E),
                   (m + ("w_gate",), (E, D, Fe), 0.0, 1 / math.sqrt(D)),
                   (m + ("w_up",), (E, D, Fe), 0.0, 1 / math.sqrt(D)),
                   (m + ("w_down",), (E, Fe, D), 0.0, 1 / math.sqrt(Fe)),
                   _w(m + ("shared", "w_gate"), D, Fs),
                   _w(m + ("shared", "w_up"), D, Fs),
                   _w(m + ("shared", "w_down"), Fs, D)]
    leaves += [_ones(("final_norm", "scale"), D),
               _w(("lm_head",), D, V)]
    return leaves


def count(doc: Dict) -> int:
    """Elements of every leaf."""
    return sum(math.prod(shape) for _, shape, _, _ in layout(doc))


def draw(doc: Dict, seed: int, device: torch.device) -> Dict:
    """The parameter tree (nested dicts, ``blocks`` a list) of views into
    one float32 buffer on ``device``, drawn from ``seed``."""
    leaves = layout(doc)
    flat = torch.empty(count(doc), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for a in range(0, flat.numel(), CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    tree: Dict = {"blocks": [{} for _ in range(doc["num_hidden_layers"])]}
    at = 0
    with torch.no_grad():
        for path, shape, mean, std in leaves:
            n = math.prod(shape)
            view = flat[at:at + n].view(shape)
            view.mul_(std).add_(mean)
            at += n
            node = tree
            for key in path[:-1]:
                node = node[key] if isinstance(key, int) \
                    else node.setdefault(key, {})
            node[path[-1]] = view
    return tree
