"""The port's fused dual-averaging update against the JAX package.

The plain PyTorch version (what ``dual_update_arena`` runs on CPU
tensors) is held BITWISE against the JAX reference
``dual_update_fused_ref`` and the Pallas kernel in interpret mode, on
the same numpy-seeded inputs. The CUDA kernel is held against the plain
version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dual_update.ops import dual_update_arena as jax_update
from repro.kernels.dual_update.ref import dual_update_fused_ref as jax_ref
from repro_torch.kernels.dual_update.ops import dual_update_arena

# a step size as the schedule makes it: 1 / (1 + sqrt((t + tau) / b_bar))
ALPHA_SCHEDULE = float(np.float32(1) / (np.float32(1) + np.sqrt(
    np.float32(7 + 4) / np.float32(800))))


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((rows, 128)).astype(np.float32)
    g = (rng.standard_normal((rows, 128)) * 300).astype(np.float32)
    return z, g


def _port(z, g, count, alpha, device="cpu", impl="auto"):
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    zt = t(z)
    z_new, w = dual_update_arena(zt, t(g), t(np.float32(count)),
                                 t(np.float32(alpha)), impl=impl)
    assert z_new is zt                     # z is updated in place
    return z_new.cpu().numpy(), w.cpu().numpy()


@pytest.mark.parametrize("rows", [256, 512])
@pytest.mark.parametrize("count", [0.0, 7.0, 1500.0])
@pytest.mark.parametrize("alpha", [0.37, ALPHA_SCHEDULE])
def test_plain_matches_jax_ref_and_interpret_kernel_bitwise(rows, count,
                                                            alpha):
    """count = 0 exercises the 1e-12 guard (g / 1e-12 stays finite for
    these magnitudes); ALPHA_SCHEDULE is a non-integer alpha as the
    step-size schedule forms it."""
    z, g = _inputs(rows, seed=rows + int(count))
    zp, wp = _port(z, g, count, alpha)
    zr, wr = jax_ref(jnp.asarray(z), jnp.asarray(g),
                     jnp.maximum(jnp.float32(count), 1e-12),
                     jnp.float32(alpha))
    zk, wk = jax_update(jnp.asarray(z), jnp.asarray(g), jnp.float32(count),
                        jnp.float32(alpha), impl="pallas", interpret=True)
    for got, want in ((zp, zr), (wp, wr), (zp, zk), (wp, wk)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert np.all(np.isfinite(wp))


def test_kernel_impl_on_cpu_tensor_raises():
    z, g = _inputs(256, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        _port(z, g, 3.0, 0.5, impl="kernel")

