"""PyTorch + CUDA port of the AMB-DG framework (Anytime Minibatch with
Delayed Gradients), beside the JAX package ``repro`` that stays its
reference.

The package mirrors ``repro``'s tree and names. It imports ``torch``
and never ``jax``, nor anything of ``repro``. Each Pallas TPU kernel on
a ported path becomes a hand-written CUDA kernel for Hopper
(``kernels/``), with its plain PyTorch version beside it. Entry points
take ``device=`` (default "cuda"); see ``api.py`` and ``train/loop.py``.
"""
