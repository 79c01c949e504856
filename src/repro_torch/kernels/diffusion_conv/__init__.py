from repro_torch.kernels.diffusion_conv.ops import diffusion_conv
from repro_torch.kernels.diffusion_conv.ref import diffusion_conv_ref

__all__ = ["diffusion_conv", "diffusion_conv_ref"]
