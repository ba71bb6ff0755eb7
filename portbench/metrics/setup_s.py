"""Process start to the first timed call: imports, the CUDA context, the
kernels' build (first run of a checkout) and load, the inputs drawn on
the card and one call at the cell's shapes."""


def read(run):
    return run.setup_s
