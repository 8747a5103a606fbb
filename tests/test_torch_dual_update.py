"""The port's dual-averaging updates against the JAX package.

The plain PyTorch versions (what ``dual_update_arena`` and the pytree
``dual_update`` run on CPU tensors) are held BITWISE against the JAX
references ``dual_update_fused_ref`` / ``dual_update_ref`` and the
Pallas kernels in interpret mode, on the same numpy-seeded inputs. The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dual_update.ops import dual_update as jax_tree_update
from repro.kernels.dual_update.ops import dual_update_arena as jax_update
from repro.kernels.dual_update.ref import dual_update_fused_ref as jax_ref
from repro.kernels.dual_update.ref import dual_update_ref as jax_plain_ref
from repro_torch.kernels.dual_update.ops import dual_update, dual_update_arena

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



@pytest.mark.parametrize("shapes", [
    [(7,)], [(128,)], [(10, 100), (77,), (3, 5, 7)],
])
@pytest.mark.parametrize("alpha", [0.37, ALPHA_SCHEDULE])
def test_pytree_update_matches_jax_bitwise(shapes, alpha):
    """The legacy pytree wrapper (z += g; w = -alpha z, no normalization)
    on the trees of tests/test_kernels.py: its plain version bitwise
    against JAX's wrapper over the Pallas kernel (interpret mode) and
    against ``dual_update_ref`` leaf by leaf; the input trees are left
    as they are."""
    rng = np.random.default_rng(len(shapes))
    z = {f"p{i}": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    g = {f"p{i}": (rng.standard_normal(s) * 300).astype(np.float32)
         for i, s in enumerate(shapes)}
    tz = {k: torch.from_numpy(v.copy()) for k, v in z.items()}
    zp, wp = dual_update(tz, {k: torch.from_numpy(v) for k, v in g.items()},
                         alpha)
    zk, wk = jax_tree_update({k: jnp.asarray(v) for k, v in z.items()},
                             {k: jnp.asarray(v) for k, v in g.items()},
                             alpha, interpret=True)
    for k in z:
        np.testing.assert_array_equal(tz[k].numpy(), z[k])
        zr, wr = jax_plain_ref(jnp.asarray(z[k]), jnp.asarray(g[k]),
                               jnp.float32(alpha))
        for got, want in ((zp[k], zk[k]), (wp[k], wk[k]), (zp[k], zr),
                          (wp[k], wr)):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pytree_kernel_impl_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="CUDA"):
        dual_update({"w": torch.zeros(7)}, {"w": torch.ones(7)}, 0.5,
                    impl="kernel")
