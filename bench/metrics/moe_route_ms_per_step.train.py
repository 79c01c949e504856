"""Device ms a step of the ops launched while ``repro_torch.route`` (the
MoE router, top-k, sort and dispatch to the experts' tiles, and the
weighted combine back to the tokens; forward and backward) was the
innermost program span open."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_device_s", "route", rec.steps)
