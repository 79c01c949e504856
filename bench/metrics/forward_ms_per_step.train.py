"""Device ms a step of the ops launched while ``repro_torch.forward`` (the
model's forward and loss; the gather nested in it has a span of its own)
was the innermost program span open."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_device_s", "forward", rec.steps)
