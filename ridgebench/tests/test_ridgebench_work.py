"""``work/``'s counts against hand-worked numbers at reduced sizes."""
import pytest

from ridgebench.tests.small import small_doc
from ridgebench.work import lm, peaks


def test_causal_pairs():
    assert lm.causal_pairs(4) == 10              # 1 + 2 + 3 + 4
    assert lm.causal_pairs(1) == 1


def test_moe_forward_flops():
    doc = small_doc("qwen2-moe-a2.7b")
    # D 64, 4/4 heads of 16, 8 experts top 2 of 24, shared 24, V 512, L 2
    attn = 4 * 64 * 64
    ffn = 64 * 8 + 2 * 3 * 64 * 24 + 3 * 64 * 24
    params = 2 * (attn + ffn) + 64 * 512
    assert lm.active_matrix_params(doc) == params
    B, S = 2, 8
    attention = 2 * 4 * B * 4 * 16 * (S * (S + 1) // 2)
    assert lm.forward_flops(doc, B, S) == 2 * params * B * S + attention


def test_products_and_least_time():
    doc = small_doc("qwen2-moe-a2.7b")
    # the shared experts' SwiGLU, 24 wide, in each of the 2 layers
    assert lm.ffn_products(doc, 2, 8)[:3] == [(16, 64, 24), (16, 64, 24),
                                              (16, 24, 64)]
    assert len(lm.ffn_products(doc, 2, 8)) == 6
    flops, nbytes = lm.product_work((16, 64, 128))
    assert flops == 2 * 16 * 64 * 128
    assert nbytes == 2 * (16 * 64 + 64 * 128 + 16 * 128)
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
