"""Distribution layer of the port (``repro/dist/__init__.py``): logical
axes -> mesh-axis specs, the specs of a batch and of a whole strategy
state, the ambient mesh and the collectives of the multi-process path.

    spec_for(axes, shape, mesh)     logical axes -> Spec
    shapes_and_axes(model)          the meta tree and its logical axes
    batch_specs(model, rc)          specs of the global batch
    state_specs(model, rc, init)    specs of the whole state
    local_shard(t, spec, mesh, c)   the block a rank holds

The port runs ``P x D x M`` meshes (``launch.mesh.make_mesh``): pods
over ranks, the arena's rows over the ``data x model`` ranks of a pod,
the dense transformers tensor parallel over ``model``
(``dist.tensor_parallel``: their specs' ``model`` entries), the weights
whole over ``data``. The specs are JAX's; where the port keeps a tensor
whole that JAX's specs would shard (the weights over ``data``, the kv
leaves whose heads do not split, the arena's counts),
``dist.tensor_parallel``, ``core.arena`` and ``core.ambdg`` say so.
"""
from __future__ import annotations

from repro_torch.dist.sharding import (Spec, _is_axes_leaf,  # noqa: F401
                                       local_shard, shapes_and_axes,
                                       spec_for)

__all__ = ["Spec", "batch_specs", "local_shard", "shapes_and_axes",
           "spec_for", "specs_for_state", "state_specs"]


def batch_specs(model, rc):
    """Specs of the global batch: dim 0 is the batch dim (over ('pod',
    'data')), everything else replicated; a scalar gets ``Spec()``."""
    shapes = model.input_shapes(rc.shape.global_batch, rc.shape.seq_len)
    return {k: spec_for(("batch",) + (None,) * (len(sh) - 1) if sh else (),
                        tuple(sh), rc.mesh)
            for k, sh in shapes.items()}


def state_specs(model, rc, init_state, generator=None):
    """Specs of the state ``init_state(generator)`` makes (see
    ``specs_for_state``)."""
    return specs_for_state(model, rc, init_state(generator))


def _tree_specs(axes_tree, shapes_tree, mesh):
    from repro_torch.core.arena import tree_flatten, tree_unflatten
    axes, _ = tree_flatten(axes_tree)
    shapes, treedef = tree_flatten(shapes_tree)
    return tree_unflatten(treedef, [spec_for(tuple(a), tuple(s.shape), mesh)
                                    for a, s in zip(axes, shapes)])


def _same_structure(a, b) -> bool:
    from repro_torch.core.arena import tree_flatten
    return (isinstance(a, dict) and isinstance(b, dict)
            and tree_flatten(a)[1] == tree_flatten(b)[1])


def specs_for_state(model, rc, state):
    """Specs of a strategy state, field by field as the JAX package
    resolves them:

      params      by their logical axes (``model.param_axes``)
      opt_state   trees shaped like params reuse the params' axes;
                  (rows, 128) leaves are arena buffers, rows over the
                  intra-pod slice; other leaves replicated
      buffer      the pytree delay buffer (``delayed.buffer_logical_axes``)
      arena       the flat delay ring (``arena.arena_logical_axes``)

    ``KBatchState`` recurses into its base with ``ref_epoch``
    replicated; the decentralized state's stacked leaves prepend a
    replicated worker dim (the worker axis is the gossip's own 1-D
    mesh). Leaves are read for their shapes only."""
    import torch

    from repro_torch.core import arena as arena_mod
    from repro_torch.core import delayed
    from repro_torch.core.strategy import DecentralizedState, KBatchState

    mesh = rc.mesh
    if isinstance(state, KBatchState):
        return KBatchState(base=specs_for_state(model, rc, state.base),
                           ref_epoch=Spec())
    params_axes = model.param_axes()

    if isinstance(state, DecentralizedState):
        from repro_torch.core.arena import tree_map
        return DecentralizedState(
            params=_tree_specs(tree_map(lambda ax: (None,) + tuple(ax),
                                        params_axes), state.params, mesh),
            z=spec_for((None, "flat", None), tuple(state.z.shape), mesh),
            residual=spec_for((None, "flat", None),
                              tuple(state.residual.shape), mesh),
            t=Spec(), step=Spec())

    def opt_specs(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            if node.dim() == 2 and node.shape[-1] == 128:  # arena rows
                return spec_for(("flat", None), tuple(node.shape), mesh)
            return Spec()
        if _same_structure(node, state.params):
            return _tree_specs(params_axes, node, mesh)
        if isinstance(node, dict):
            return {k: opt_specs(v) for k, v in node.items()}
        children = [opt_specs(c) for c in node]
        return type(node)(*children) if hasattr(node, "_fields") \
            else type(node)(children)

    fields = {"params": _tree_specs(params_axes, state.params, mesh),
              "opt_state": opt_specs(state.opt_state), "step": Spec()}
    if getattr(state, "buffer", None) is not None:
        buf_axes = delayed.buffer_logical_axes(
            params_axes, rc.ambdg.tau, rc.ambdg.pod_compression)
        fields["buffer"] = delayed.DelayBuffer(*[
            None if ax is None else
            (spec_for(tuple(ax), tuple(sh.shape), mesh)
             if _is_axes_leaf(ax) else _tree_specs(ax, sh, mesh))
            for ax, sh in zip(buf_axes, state.buffer)])
    if getattr(state, "arena", None) is not None:
        fields["arena"] = arena_mod.arena_specs(state.arena, mesh)
    return type(state)(**{f: fields.get(f) for f in state._fields})
