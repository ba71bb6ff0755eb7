"""Ensemble Newton iterations per profiled call
(``loop_counts["newton_trips"]``, zeroed before each call and read after
it): whole solves from the window's first call, the calls whose
device time the traced run reads."""


def read(run):
    if run.traced_calls == 0:
        return None
    return run.traced_counters["newton_trips"] / run.traced_calls
