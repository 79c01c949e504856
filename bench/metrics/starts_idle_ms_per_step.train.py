"""Device idle ms a step in the gaps whose midpoint fell inside
``repro_torch.starts`` (``DataPlane.batch_of_starts``: the host check and
the starts' copy from pageable memory, which synchronises)."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_idle_s", "starts", rec.steps)
