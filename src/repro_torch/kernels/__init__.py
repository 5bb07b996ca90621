"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Kernels are built and loaded at first use (:mod:`repro_torch.kernels.build`),
never on import.
"""
