"""Reduced copies of the cells' files, for runs on the CPU in the tests:
the configurations' own files with their sizes cut, and short traffic."""
from __future__ import annotations

import copy
from typing import Dict

from ridgebench import harness

SMALL = {
    "qwen2-moe-a2.7b": dict(num_hidden_layers=2, hidden_size=64,
                            num_attention_heads=4, num_key_value_heads=4,
                            intermediate_size=96, vocab_size=512,
                            num_experts=8, num_experts_per_tok=2,
                            moe_intermediate_size=24,
                            shared_expert_intermediate_size=24),
}
PORT = {"qwen2-moe-a2.7b": {"moe_group_tokens": 32}}


def small_doc(config: str) -> Dict:
    doc = copy.deepcopy(harness.load_json(
        harness.HERE / "configs" / f"{config}.json"))
    doc.update(SMALL[config])
    doc["port"].update(PORT[config])
    return doc


def small_files(name: str, **port) -> Dict:
    """The cell's files with the reduced configuration and (2, 32)
    traffic; ``port`` overrides the configuration's port settings."""
    w = harness.workload(name)
    files = harness.cell_files(w)
    files["doc"] = small_doc(w["config"])
    files["doc"]["port"].update(port)
    files["traffic"] = dict(files["traffic"], batch=2, seq=32)
    return files
