"""Roofline model: three terms per (arch × shape × mesh) from the dry-run.

    compute    t_c = FLOPs/device        / peak FLOP/s           (tensor cores)
    memory     t_m = bytes/device        / HBM bandwidth         (HBM ceiling)
    collective t_x = coll bytes/device   / network bandwidth     (link ceiling)

The dry-run's counts are already per device (the cost counter sees one
rank's local ops), so each term divides by one device's ceiling.  Step time
lower bound = max(terms), assuming perfect overlap; the dominant term is the
bottleneck.

MODEL_FLOPS = 6·N·D (dense train), 6·N_active·D (MoE train), 2·N·D forward
(prefill/decode); the ratio MODEL_FLOPS / (counted FLOPs × devices) exposes
remat and redundant compute.

Hardware: NVIDIA H100 SXM5 80GB, datasheet figures (not measured here):
989 TFLOP/s bf16 dense tensor-core math, 67 TFLOP/s fp32 (the port runs with
TF32 off, so float32 matmuls run at the fp32 rate), 3.35 TB/s HBM3.  Both
16-wide production axes span two 8-GPU NVLink nodes, so a collective over
either crosses the inter-node network: 50 GB/s a GPU (one 400 Gb/s NDR
InfiniBand port each).  Inside one node NVLink gives 900 GB/s a GPU; the
bound does not use it.
"""
from __future__ import annotations

import argparse
import json

PEAK_FLOPS_BF16 = 989e12  # H100 SXM datasheet, dense bf16 tensor core
PEAK_FLOPS_FP32 = 67e12  # H100 SXM datasheet, fp32 (TF32 off)
HBM_BW = 3.35e12  # H100 SXM datasheet, HBM3 bytes/s
NET_BW = 50e9  # bytes/s a GPU: one 400 Gb/s NDR InfiniBand port (NVLink: 900e9)


def compute_dtype(rec: dict) -> str:
    """The dtype of the cell's matmuls: the record's ``compute_dtype`` (the
    port's dry-run writes it), else bf16 for the LM cells and float32 for
    the ST-GNN cells (those with an analytic ``flops_model``)."""
    if rec.get("compute_dtype"):
        return rec["compute_dtype"]
    return "float32" if "flops_model" in rec.get("meta", {}) else "bfloat16"


def peak_flops(rec: dict) -> float:
    return PEAK_FLOPS_FP32 if compute_dtype(rec) == "float32" else PEAK_FLOPS_BF16


def model_flops(rec: dict) -> float:
    """Useful (6ND-style) FLOPs for the whole step, all devices."""
    meta = rec.get("meta", {})
    if "flops_model" in meta:  # ST-GNN analytic count
        return float(meta["flops_model"])
    n_active = float(meta.get("active_params", 0.0))
    tokens = float(meta.get("tokens_per_step", 0.0))
    if rec.get("kind") == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens  # prefill/decode forward only


def roofline_terms(rec: dict) -> dict:
    """Three terms (seconds) + bottleneck + usefulness ratio for one record."""
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    coll_dev = rec["collectives"]["total"]
    chips = rec["chips"]
    peak = peak_flops(rec)
    t_c = flops_dev / peak
    t_m = bytes_dev / HBM_BW
    t_x = coll_dev / NET_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec)
    total = flops_dev * chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_lower_bound_s": bound,
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_ratio": (mf / total) if total else 0.0,
        # fraction of the roofline the *useful* math achieves if the step ran
        # exactly at the lower bound
        "roofline_fraction": (mf / chips / peak) / bound if bound else 0.0,
    }


def summarize(records: list[dict]) -> list[dict]:
    out = []
    for rec in records:
        if rec.get("status") != "ok":
            out.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                        "mesh": rec.get("mesh"), "status": rec.get("status"),
                        "reason": rec.get("reason") or rec.get("error")})
            continue
        shape = rec["shape"]
        placement = rec.get("meta", {}).get("placement")
        if placement and placement != "replicated":
            shape = f"{shape}:{placement[:4]}"
        row = {"arch": rec["arch"], "shape": shape, "mesh": rec["mesh"],
               "kind": rec["kind"], "status": "ok",
               "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
               **roofline_terms(rec)}
        out.append(row)
    return out


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':24} {'shape':12} {'mesh':8} {'t_comp(s)':>10} {'t_mem(s)':>10} "
           f"{'t_coll(s)':>10} {'bound':>10} {'dom':>7} {'useful':>7} {'RF%':>6} {'GiB/dev':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r.get('arch') or '?':24} {r.get('shape') or '?':12} "
                         f"{r.get('mesh') or '-':8} {r.get('status')}: "
                         f"{str(r.get('reason'))[:60]}")
            continue
        lines.append(
            f"{r['arch']:24} {r['shape']:12} {r['mesh']:8} "
            f"{r['compute_s']:10.4f} {r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['step_lower_bound_s']:10.4f} {r['dominant']:>7} "
            f"{r['useful_ratio']:7.3f} {100*r['roofline_fraction']:6.1f} "
            f"{r['peak_gib']:8.2f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("records", help="JSON file written by repro_torch.launch.dryrun")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    with open(args.records) as f:
        records = json.load(f)
    if isinstance(records, dict):
        records = [records]
    rows = summarize(records)
    print(format_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
