"""train_tokens_per_s: the tokens of every step of the window over the
time from the window's start to the synchronise after its last step (host
clock)."""


def read(rec):
    mix = rec.cell.traffic
    return rec.steps * mix["batch"] * mix["seq"] / rec.window_s
