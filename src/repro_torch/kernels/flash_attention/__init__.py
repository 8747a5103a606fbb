"""Flash attention: the CUDA forward (with and without lse) and backward
(dq, dk/dv) kernels, their plain versions, and the wrappers."""
