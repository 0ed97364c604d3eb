"""setup_s: the process's start to the first timed wave: imports, kernel
builds on a cold checkout, network and models, the decode artifact, the
tables on the card, the pool and the warm-up waves (host clock)."""


def read(run):
    return run.setup_s
