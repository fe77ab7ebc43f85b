"""setup_s: seconds from the start of the run's process to the window:
imports, the kernel library (built on a checkout's first run), the weights
drawn on the card, the cell's shapes warmed (host clock)."""


def read(rec):
    return rec.setup_s
