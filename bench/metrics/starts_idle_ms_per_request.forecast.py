"""Device idle ms a request in the gaps whose midpoint fell inside
``repro_torch.starts`` (``DataPlane.batch_of_starts``)."""


def read(rec):
    if rec.mode != "forecast" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_idle_s", "starts", rec.steps)
