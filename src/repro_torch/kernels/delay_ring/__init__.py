"""int8 delay-ring slot rotate: CUDA kernel, plain version, wrapper."""
