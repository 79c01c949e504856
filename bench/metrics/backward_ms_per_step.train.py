"""Device ms a step of the ops launched while ``repro_torch.backward``
(``torch.autograd.grad``, its kernels launched from autograd's own thread)
was the innermost program span open."""


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    return rec.trace.span_ms("span_device_s", "backward", rec.steps)
