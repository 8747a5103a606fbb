"""AMB-DG on the MoE slice against the JAX package: mixtral-8x7b and
mixtral-8x22b SMOKE (4 experts, top 2, a window of 32), f32 compute,
through both packages' ``api.build`` (tau 2, two microbatches, no pod
compression) in lockstep: 6 steps from JAX's init on the same
``AnytimePipeline`` batches of S = 64 (twice the window). Applied and
local counts exact, loss and grad norm to rtol 1e-5, the final w and z
to 1e-5 of their largest element (``test_torch_lm_slice.py``'s limits).
Step 5 applies the gradient taken at step 3's weights. (At w = 0,
after the first empty pop, ROADMAP C.8, every router logit is 0 and
every expert ties; ``test_torch_moe.py`` holds the port's routing of
such ties to JAX's.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import base as jbase
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import AnytimePipeline as JaxPipeline
from repro.models.api import build_model as jax_build_model
from repro_torch import api, convert
from repro_torch.configs import base, get_smoke_config
from repro_torch.core.arena import tree_flatten
from repro_torch.data.pipeline import AnytimePipeline
from repro_torch.models.api import build_model

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
SEQ = 64
N_STEPS, N_WORKERS, SPW = 6, 2, 2


def _f32(cfg_fn, arch):
    return dataclasses.replace(cfg_fn(arch), compute_dtype="float32")


def _close(got, want, tol, what=""):
    got, want = got.numpy(), np.asarray(want, np.float32)
    gap, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert gap <= tol * scale, (what, gap, scale)


def _rc(cfgs, model_cfg):
    return cfgs.RunConfig(
        model=model_cfg,
        shape=dataclasses.replace(cfgs.TRAIN_4K, seq_len=SEQ,
                                  global_batch=N_WORKERS * SPW),
        mesh=cfgs.MeshConfig(n_pods=1, data=1, model=1),
        ambdg=cfgs.AmbdgConfig(tau=2, n_microbatches=2, b_bar=4.0,
                               smoothness_L=8.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_ambdg_steps_match_jax(arch):
    jcfg, cfg = _f32(jax_smoke_config, arch), _f32(get_smoke_config, arch)
    js = japi.build(jax_build_model(jcfg), _rc(jbase, jcfg))
    ps = api.build(build_model(cfg, device="cpu"), _rc(base, cfg),
                   device="cpu")
    jstate = js.init_state(jax.random.PRNGKey(0))
    pstate = ps.init_state(torch.Generator().manual_seed(0))
    pstate = pstate._replace(params=convert.params_from_jax(
        jax.device_get(jstate.params), device="cpu"))
    jpipe = JaxPipeline(jcfg, N_WORKERS, SPW, seq_len=SEQ, seed=0)
    pipe = AnytimePipeline(cfg, N_WORKERS, SPW, seq_len=SEQ, seed=0)
    for t in range(N_STEPS):
        batch, jbatch = pipe.next_global_batch(), jpipe.next_global_batch()
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        jstate, jm = js.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        pstate, pm = ps.train_step(pstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        assert pm["applied_count"].item() == float(jm["applied_count"])
        assert (pm["applied_count"].item() == 0.0) == (t < 2)
        assert pm["local_count"].item() == float(jm["local_count"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(pm[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} at {t}")
    assert float(jm["grad_norm"]) > 0.0
    jz = np.asarray(jstate.opt_state.z)
    _close(pstate.opt_state.z, jz, 1e-5, "z")
    for w, jw in zip(tree_flatten(pstate.params)[0],
                     jax.tree.leaves(jstate.params)):
        assert np.all(np.isfinite(w.numpy()))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-5 * np.abs(jz).max())
