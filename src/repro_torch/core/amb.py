"""AMB baseline (Ferdinand et al., ICLR'19) — the paper's primary
comparison (``repro/core/amb.py``).

Identical anytime aggregation and dual-averaging update, but
*synchronous*: the master's update uses the current epoch's gradients
(no staleness) and workers idle for the full round trip T_c after every
transmission. On the device this is the AMB-DG step with tau = 0; the
wall-clock penalty (epoch duration T_p + T_c instead of T_p) is modeled
by the cluster simulator / timeline (``core.staleness``).
"""
from __future__ import annotations

from repro_torch.configs.base import RunConfig
from repro_torch.models.api import Model


def make_amb_train_step(model: Model, rc: RunConfig):
    """Deprecated alias — ``repro_torch.api.build(model,
    rc.replace(strategy="amb"))`` is the Strategy-registry spelling. The
    strategy runs on the device ``model`` was built for."""
    from repro_torch import api
    s = api.build(model, rc.replace(strategy="amb"), device=model.device)
    return s.init_state, s.train_step
