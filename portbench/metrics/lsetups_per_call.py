"""Linear-solver setups, each one ``soa_setup``, per profiled call
(``loop_counts["lsetups"]``, zeroed before each call and read after it):
whole solves from the window's first call, the calls whose device
time the traced run reads."""


def read(run):
    if run.traced_calls == 0:
        return None
    return run.traced_counters["lsetups"] / run.traced_calls
