"""Set-up: from the start of the process to the start of the window
(imports, the card's start, kernel builds in a first run, inputs made from
the seed, warm-up), on the host clock."""


def read(run):
    return run.setup_s
