"""PyTorch/CUDA port of the quadtree block-sparse matrix library.

Mirrors the JAX package ``repro`` module for module (``repro_torch.core.matrix``
is the counterpart of ``repro.core.matrix``) and imports nothing of it.  The
numeric phase runs a hand-written CUDA kernel on an NVIDIA Hopper card
(:mod:`repro_torch.kernels.block_spmm`); tensors on the CPU take the kernel's
plain PyTorch version instead.  Constructors place data on ``"cuda"`` unless
the caller passes ``device="cpu"``; every other operation follows its
operands' device.
"""
