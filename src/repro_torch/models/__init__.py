"""Models of the port: the paper's DCRNN baseline, its §3 case-study model
PGT-DCRNN, and the §5.5 models A3T-GCN and ST-LLM (on the LM backbone of
``models.lm``)."""
from repro_torch.models import a3tgcn, dcrnn, pgt_dcrnn, stllm

__all__ = ["a3tgcn", "dcrnn", "pgt_dcrnn", "stllm"]
