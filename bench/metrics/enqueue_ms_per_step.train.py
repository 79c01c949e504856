"""Host ms inside ``Engine.batch_of_starts`` + ``Engine.train_step`` a
step, the mean over the window's steps (the benchmark's span)."""


def read(rec):
    host = rec.spans.get("train_step")
    if rec.mode != "train" or not host:
        return None
    return sum(host) / len(host) * 1e3
