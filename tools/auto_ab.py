#!/usr/bin/env python3
"""The host cost of a dispatch change, parent against this tree, on the
card.

    python3 tools/auto_ab.py --parent DIR [--order PCCP]

DIR is a checkout of the parent commit (``git archive <commit>``
unpacked under ``build/``, which ``.gitignore`` lists).  For each letter
of ``--order`` (P the parent, C this tree; default parent, change,
change, parent) a fresh process imports that tree's ``chip_smoke.py``,
builds its kernels and runs two of its phases as that script runs them:
the main path (2**20 Robertson systems through ``ensemble_bdf`` under
the default policy, then its plain run) and path M (the serving tier's
65536-lane bundles, its warm leg, the async facade, the plain server and
chaos).  It prints, per run, the main path's wall and host syncs and
each served bundle's wall, run and host syncs, and writes them to
``chip_smoke_out/auto_ab.json``.  Compare the trees only within one
call (one card), in the order's turns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build_all()
for name in _build.SOURCES:
    _build.load(name)
card = cs.card_line()
main = cs.phase_main_path(False)
run = main["kernels_run"]
out = {"card": card, "main_wall_s": run["wall_s"],
       "main_host_syncs": run["loop"]["host_syncs"]}
m = cs.phase_path_m(card, False)
out["m_bundles"] = [
    {"leg": leg, "family": b["family"], "live": b["live"],
     "nsys": b["nsys"], "wall_s": b["wall_s"], "run_s": b["run_s"],
     "host_syncs": b["loop"]["host_syncs"]}
    for leg, rec in m["legs"].items() if isinstance(rec, dict)
    for b in rec.get("bundles", ())]
print("AUTO_AB " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{tree}: exit code {proc.returncode}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("AUTO_AB "))
    return json.loads(line[len("AUTO_AB "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--order", default="PCCP")
    args = ap.parse_args(argv)
    trees = {"P": args.parent.resolve(), "C": ROOT}
    runs = []
    for letter in args.order:
        rec = run_tree(trees[letter])
        rec["tree"] = "parent" if letter == "P" else "change"
        runs.append(rec)
        big = [b for b in rec["m_bundles"] if b["nsys"] == 65536]
        print(f"{rec['tree']} on {rec['card']}: main path wall "
              f"{rec['main_wall_s']:.3f} s, host syncs "
              f"{rec['main_host_syncs']}; M's 65536-lane bundles: "
              + ", ".join(f"{b['leg']} {b['family']} {b['wall_s']:.3f} s "
                          f"(run {b['run_s']:.3f} s, {b['host_syncs']} "
                          f"syncs)" for b in big), flush=True)
    out = ROOT / "chip_smoke_out"
    out.mkdir(exist_ok=True)
    (out / "auto_ab.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
