"""PyTorch/CUDA port of alchemy_tpu.

The JAX package `alchemy_tpu` is the reference: every op here returns the
same uint32 residues as its counterpart there (3-factor NTT slot order,
same seeded host sampling). This package imports torch and never jax.
Residues are stored as int32 tensors (canonical values are < 2^31) and
computed on in int64 by the plain versions; the CUDA kernels read the same
buffers as uint32.
"""
