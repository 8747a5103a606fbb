"""The port's int8 delay-ring slot rotate against the JAX package.

The plain PyTorch version (what ``ring_slot_rotate_int8`` runs on CPU
tensors) is held BITWISE against the JAX reference
``ring_slot_rotate_int8_ref`` (popped, q, scales, residual) and the
Pallas ``delay_ring_slot_fwd`` in interpret mode (popped, q, scales; its
residual is the FMA-contracted form, held exactly to that). The inputs
put ``fed / s`` exactly on +-k.5 (round half to even, not away from
zero) and past +-127 (the clip). The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delay_ring.kernel import delay_ring_slot_fwd
from repro.kernels.delay_ring.ref import ring_slot_rotate_int8_ref as jax_ref
from repro_torch.kernels.delay_ring.ops import ring_slot_rotate_int8


def _inputs(n_pods, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (n_pods, rows, 128)
    slot_pop = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales_pop = rng.uniform(1e-3, 1.0, size=shape[:2]).astype(np.float32)
    scale_new = rng.uniform(1e-3, 1.0, size=shape[:2]).astype(np.float32)
    fed = rng.standard_normal(shape).astype(np.float32)
    # rows whose scale is a power of two make fed / s exact: half-way
    # values +-(k + 0.5), and values beyond the +-127 clip
    scale_new[:, :64] = 2.0 ** -6
    k = rng.integers(-130, 130, size=(n_pods, 32, 128))
    fed[:, :32] = ((k + 0.5) * 2.0 ** -6).astype(np.float32)
    fed[:, 32:48] = (rng.choice([-1, 1], size=(n_pods, 16, 128))
                     * rng.uniform(127.5, 300, size=(n_pods, 16, 128))
                     * 2.0 ** -6).astype(np.float32)
    fed[:, 48:64, :8] = 0.5 * 2.0 ** -6     # the 0.5 -> 0 tie
    fed[:, 48:64, 8:16] = -1.5 * 2.0 ** -6  # the -1.5 -> -2 tie
    slot_push = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales_push = rng.uniform(size=shape[:2]).astype(np.float32)
    return slot_pop, scales_pop, slot_push, scales_push, fed, scale_new


def _port(args, device="cpu", impl="auto"):
    ts = [torch.from_numpy(np.array(a)).to(device) for a in args]
    popped, slot, sc, res = ring_slot_rotate_int8(*ts, impl=impl)
    assert slot is ts[2] and sc is ts[3] and res is ts[4]   # in place
    return [x.cpu().numpy() for x in (popped, slot, sc, res)]


@pytest.mark.parametrize("n_pods", [1, 3])
def test_plain_matches_jax_ref_and_interpret_kernel_bitwise(n_pods):
    args = _inputs(n_pods, 256, seed=n_pods)
    got = _port(args)
    slot_pop, scales_pop, slot_push, scales_push, fed, scale_new = map(
        jnp.asarray, args)
    want_ref = jax_ref(slot_pop, scales_pop, fed, scale_new)
    want_kernel = delay_ring_slot_fwd(slot_pop, scales_pop, slot_push,
                                      scales_push, fed, scale_new,
                                      interpret=True)
    names = ("popped", "q", "scales", "residual")
    for name, g, w in zip(names, got, want_ref):
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    for name, g, w in zip(names[:3], got, want_kernel):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # XLA:CPU contracts the interpret-mode kernel's fed - q * s into one
    # fused multiply-subtract (the JAX reference pins it apart with an
    # optimization_barrier, as the port and the CUDA kernel do). Hold
    # that residual to the fused form of the same q and s, exactly:
    # q * s and the difference are exact in float64, so one rounding
    # to float32 is the FMA's.
    fed, s = args[4], args[5][..., None]
    q64 = got[1].astype(np.float64)
    fused = (fed.astype(np.float64) - q64 * s.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(want_kernel[3]),
                                  fused.astype(np.float32))
    np.testing.assert_array_equal(got[3], fed - (q64.astype(np.float32) * s))
    q = got[1].astype(np.int32)
    assert q.min() == -127 and q.max() == 127          # the clip is hit
    assert np.all(q[:, 48:64, :8] == 0)                # 0.5 -> 0
    assert np.all(q[:, 48:64, 8:16] == -2)             # -1.5 -> -2


def test_kernel_impl_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        _port(_inputs(1, 256, seed=0), impl="kernel")

