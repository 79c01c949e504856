"""Models of the port.  So far the paper's §3 case-study model, PGT-DCRNN."""
from repro_torch.models import pgt_dcrnn

__all__ = ["pgt_dcrnn"]
