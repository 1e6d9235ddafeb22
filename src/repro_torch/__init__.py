"""PyTorch and CUDA port of the Revati reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  See the README section on the port.
"""
