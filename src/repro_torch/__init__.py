"""PyTorch/CUDA port of the PGT-I index-batching system.

Mirrors the layout of the JAX package ``repro`` module for module, without
importing it or JAX.  Entry points (``build_pipeline``,
``IndexDataset.to_device``, ``models.pgt_dcrnn.init``) run on ``"cuda"``
unless the caller passes ``device="cpu"``; a CUDA request without a card
raises (see :func:`repro_torch.device.resolve_device`).

The two kernels of the ST-GNN path, ``window_gather`` and ``hop_project``,
are hand-written CUDA C++ for Hopper (``kernels/csrc``), built with ``nvcc``
at first use; each has a plain PyTorch version that CPU tensors use.
"""
