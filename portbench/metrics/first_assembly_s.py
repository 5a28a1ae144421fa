"""The process's first assembly, in seconds: after the kernels are built
or loaded from their directories, before the card is touched; it holds
the CUDA context, the module loads and the cold parse, to the last GFA
byte and a synchronize.  What a user of the one-shot CLI pays; part of
`setup_s`."""

LAYER = "entry"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.first_s
