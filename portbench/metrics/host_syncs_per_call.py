"""Counted device-to-host reads of the port's host loops per profiled call
(``core/loops.py`` ``loop_counts["host_syncs"]``, zeroed before each
call and read after it): whole solves from the window's first call,
the calls whose device time the traced run reads."""


def read(run):
    if run.traced_calls == 0:
        return None
    return run.traced_counters["host_syncs"] / run.traced_calls
