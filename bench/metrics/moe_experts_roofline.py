"""Share of the compute roofline that the MoE expert products reach: the
routed experts' FLOPs of the window's steps, from the program's count of
the token-expert pairs it computed (``moe.assignments``), and the shared
experts' over every token of every MoE layer, forward and backward, over
495 TFLOP/s, against the device time of the ops launched in the
``repro_torch.experts`` span, in percent."""
from bench.peaks import TF32_FLOPS


def read(rec):
    if rec.mode != "train" or rec.trace is None:
        return None
    counts = rec.cell.counts()
    assignments = rec.counters.get("moe.assignments")
    secs = rec.trace.span_device_s.get("experts")
    if not hasattr(counts, "routed_expert_flops") or not assignments or not secs:
        return None
    cfg = rec.cell.config
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    tokens = rec.steps * rec.batch * cfg["num_nodes"]
    work = (counts.routed_expert_flops(cfg, assignments, train=True)
            + moe_layers * counts.shared_expert_flops(cfg, tokens, train=True))
    return 100.0 * work / TF32_FLOPS / secs
