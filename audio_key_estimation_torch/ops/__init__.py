"""Compute ops: CQT front-end (plain and CUDA kernels A/B), equivariant
convs, pooling, masked pooling, fused ConvStack (CUDA kernel C)."""
