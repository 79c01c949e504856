"""Device ms a step of the ops launched while ``repro_torch.optimizer``
(``optim.apply_updates``: global norm, clip, AdamW) was the innermost
program span open."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_device_s", "optimizer", rec.steps)
