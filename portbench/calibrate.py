"""Readings for the limits of ``correct``: the numbers the comparison
with the reference gives, one JSON line a seed, for several seeds in one
process (one build, one CUDA context).

    python portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--dtype float32]

``--dtype float32`` runs the control: the program's own float32 path
(the problem built in float32, the kernels' float32 bodies) in place of
the configuration's float64.  The benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv):
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    from portbench.harness import check, device, manifest, session
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--dtype", default=None)
    args = p.parse_args(argv)
    man = manifest.Manifest(root)
    cell = man.cell(args.workload)
    device.require(cell["chips"])
    dtype = getattr(torch, args.dtype) if args.dtype else None
    for seed in (int(s) for s in args.seeds.split(",")):
        run = session.run(man, cell["name"], seed, args.seconds, False,
                          time.perf_counter(), dtype=dtype)
        family = man.family(run.cfg["family"])
        values = check.numbers(run, family)
        correct, _ = check.verdict(values, run.limits)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "dtype": str(run.dtype), "calls": run.calls,
                          "correct": correct, **values}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
