"""Seconds from process start to the first timed call: imports, inputs,
the program's set-up (scaler, supports, resident series), kernel builds
and loads, and the warm-up calls."""


def read(rec):
    return rec.setup_s
