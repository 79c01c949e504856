"""Device idle ms a request in the gaps whose midpoint fell inside
``repro_torch.gather`` (the window gather from the resident series)."""


def read(rec):
    if rec.mode != "forecast" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_idle_s", "gather", rec.steps)
