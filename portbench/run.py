"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, configurations and metrics are
listed in ``BENCHMARK.json``; see ``portbench/harness/cli.py``.
"""
import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()``'s reading when this process started (from
    the kernel's start time of the process; the reading now if that
    cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rpartition(")")[2].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_PROC = _process_start()
    from pathlib import Path
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness.cli import main
    sys.exit(main(sys.argv[1:], ROOT, T_PROC))
