"""From process start until the window opens: the network drawn from the
seed, the program's set-up (for a center: the .gr file written, parsed and
B built on the card) and the warm-up of the mix's shapes."""


def read(rec):
    return rec.setup_s
