"""Set-up: seconds from the process's start to the window's first call
(imports, the card's context, inputs from the seed, the problem on the
card, the kernels loaded or built, the warm-up at the cell's shapes).
Host clock."""


def read(run):
    return run.setup_s
