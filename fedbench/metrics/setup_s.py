"""setup_s: from the command's start to the first timed round: the party
processes, the federation, the weights, the kernels' build or load, and
the warm-up rounds."""

TRACE, UNIT = 0, "s"


def read(ctx):
    return ctx["window"]["t0"] - ctx["t_cmd0"]
