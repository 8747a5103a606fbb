"""Delay-ring kernels: the v2 int8 slot rotate, the v1 stacked-ring
rotate and the v3 variable pop (CUDA kernels, plain versions,
wrappers)."""
