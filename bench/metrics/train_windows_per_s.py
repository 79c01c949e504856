"""Windows trained a second: steps x batch over the window, from its start
to the end of its last step (after a synchronise)."""


def read(rec):
    if rec.mode != "train":
        return None
    return rec.steps * rec.batch / rec.window_s
