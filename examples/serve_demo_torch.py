"""Serving demo on the PyTorch port: batched greedy decoding with the
KV-cache / recurrent-state engines, across three architecture families
(dense KV cache, xLSTM constant state, Hymba sliding-window hybrid).

The counterpart of ``examples/serve_demo.py``: the same reduced configs in
fp32, batch 4, an 8-token prompt and 24 new tokens, on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import AdamW
from repro_torch.serve.engine import greedy_generate
from repro_torch.train.loop import init_train_state


def demo(arch: str, device: torch.device, steps: int = 24):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    params = init_train_state(torch.Generator(device=device).manual_seed(0),
                              cfg, AdamW(), device=device).params
    prompt = torch.randint(0, cfg.vocab_size, (4, 8), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, steps=steps,
                          max_len=8 + steps)
    dt = time.perf_counter() - t0
    n_new = out.shape[1] - prompt.shape[1]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"{arch:<18} family={cfg.family:<7} batch=4  "
          f"+{n_new} tokens in {dt:.2f}s "
          f"({4 * n_new / dt:.0f} tok/s on {where})")
    assert out.shape == (4, 8 + steps)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)
    for arch in ("smollm-135m", "xlstm-125m", "hymba-1.5b"):
        demo(arch, device)
    print("OK")


if __name__ == "__main__":
    main()
