"""How far one device's float64 xlstm gradient resolves ``chip_smoke.py``
T.1's gates, by sequence length (CPU only).

T.1 holds the sharded (fsdp) gradients of each family's FULL width to
one device's, with fixed gates.  A gate can only be held if one
device's own result is stable to it: this script takes T.1's xlstm-125m
cut (its weights, seed 0; its batch, numpy seed 5, 2 rows) at each
sequence length given and prints one device's loss, the number of
non-finite gradient entries, and how far a nudge of the embedding by a
factor ``1 + n`` (n in ``chip_smoke.T1_NUDGES``) moves the loss and the
gradients, measured as T.1 measures the sharded run (the largest
difference where both are finite over the leaf's largest entry; inf
where the non-finite entries move) together with the three leaves that
move most.  Two nudge sizes a hundred apart tell rounding (both at the
float32 floor of the gradients), smooth sensitivity (the reading
scales with the nudge) and chaos (readings far past the nudge, not
scaling with it) apart.

    PYTHONPATH=src python tools/xlstm_nudge_witness.py [--seq 16 64 128 256]

It imports only the port and ``chip_smoke.py``, and runs on the CPU;
the four default lengths take about a minute on 6 threads.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, nargs="+", default=[16, 64, 128, 256])
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    from repro_torch.models import spec

    torch.set_num_threads(args.threads)
    arch, layers = "xlstm-125m", 2
    cpu = torch.device("cpu")
    model = cs.t_model(arch, layers, torch.float64)
    params = cs.t_weights(arch, layers)
    for seq in args.seq:
        batch = cs.t1_batch(model.cfg, seq, cpu)
        t0 = time.perf_counter()
        loss, g = cs.t1_grads(model, params, batch)
        sec = time.perf_counter() - t0
        g = spec.tree_leaves(g)
        nonfinite = sum(int((~torch.isfinite(x)).sum()) for x in g)
        print(f"{arch} x {layers} layers, batch {cs.T_BATCH} x {seq}: loss "
              f"{float(loss):.15g} ({sec:.1f} s), {nonfinite} non-finite "
              f"gradient entries", flush=True)
        for n in cs.T1_NUDGES:
            loss_n, g_n = cs.t1_grads(model, params, batch, nudge=n)
            rels = [cs.t1_rel(a, b)
                    for a, b in zip(spec.tree_leaves(g_n), g)]
            worst = sorted(range(len(rels)), key=lambda i: -rels[i])[:3]
            rel = abs(float(loss_n - loss)) / abs(float(loss))
            print(f"  nudge {n:g}: loss {rel:.3g}, "
                  f"gradients {max(rels):.3g}; leaves "
                  + ", ".join(f"{i} {tuple(g[i].shape)} {rels[i]:.3g}"
                              for i in worst), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
