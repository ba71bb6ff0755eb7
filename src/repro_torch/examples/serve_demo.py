"""Serving example: batched autoregressive decode with KV caches.

The port of ``examples/serve_demo.py``: a model of the registry with
weights drawn from a seed, a random prompt batch, and
:func:`repro_torch.serve.decode.generate` over it.  Runs on the card;
``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_demo \\
          [--arch internlm2-1.8b-smoke] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.policies import resolve_device
from repro_torch.models import Model
from repro_torch.serve import decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    model = Model(cfg)
    params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    extra = None
    if cfg.enc_dec:
        extra = {"enc_out": 0.02 * torch.ones(
            (args.batch, 8, cfg.d_model), dtype=cfg.dtype, device=dev)}
    t0 = time.perf_counter()
    out = decode.generate(model, params, prompt, args.max_new,
                          temperature=args.temperature,
                          generator=torch.Generator(device=dev).manual_seed(2),
                          extra_batch=extra, device=dev)
    rows = out.cpu()              # waits for the device
    wall = time.perf_counter() - t0
    total_new = args.batch * args.max_new
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} device={dev}")
    print(f"generated {total_new} tokens in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s on {dev})")
    for row in rows[:2]:
        print("  tokens:", row.tolist())
    return rows


if __name__ == "__main__":
    main()
