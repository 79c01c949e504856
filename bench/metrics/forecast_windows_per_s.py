"""Windows forecast a second, the forecasts on the host, over the window."""


def read(rec):
    if rec.mode != "forecast":
        return None
    return rec.steps * rec.batch / rec.window_s
