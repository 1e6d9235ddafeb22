"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
dispatch (:mod:`repro_torch.kernels.ops`)."""
