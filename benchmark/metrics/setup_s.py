"""`setup_s` (s): from the process's start to the window's start: imports,
the kernels' build where the checkout has none yet, the inputs made from
the seed, the program's set-up and the warm-up of the cell's shapes."""


def read(ctx) -> float:
    return ctx.setup_s
