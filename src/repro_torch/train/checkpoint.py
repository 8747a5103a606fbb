"""Checkpointing of the port (``repro/train/checkpoint.py``): atomic
save/restore of a whole training state, with retention.

  * every tensor leaf of the state (params, z, the delay ring, its
    int8 scales and residual, counts, head, step) is saved, so a
    restarted run reproduces the exact update sequence, the gradients in
    flight included; the loop adds the pipeline cursor, the seeded
    processes' states and the step to ``extra``;
  * a save writes ``<dir>/tmp.<step>`` and then ``os.replace``s it into
    ``<dir>/step_<step>``, so a crash mid-save never corrupts the latest
    checkpoint; the ``keep`` most recent are kept;
  * under a multi-rank mesh (``save_sharded``, ``restore(...,
    shard=)``) each rank's shards of z and the arena are joined on
    rank 0's host into the checkpoint a single process would write, and
    a restart cuts each rank's shards from it on the host; on the
    per-rank gossip the workers' slices of params, z and residual are
    joined along the worker axis alike, into the dense run's checkpoint.

The format is the JAX package's: one ``state.npz`` of leaves keyed by
their path (a NamedTuple field ``.name``, a dict key, a sequence index,
joined by "/", as ``jax.tree_util.tree_flatten_with_path`` names them)
and a ``manifest.json`` with the step, the keys and ``extra``. So a
checkpoint either package writes restores in the other. Tensors reach
numpy through ``.cpu()`` in their own dtype (an int8 ring stays int8);
``restore`` places each leaf on its template leaf's device. Checkpoints
of the older ring layouts migrate on restore as in JAX (v1 into a v2
template, the per-slot delay-tolerant ring into the stacked v3), and a
decentralized checkpoint saved before the gossip residual existed
restores with a zero residual. A numpy array in ``extra`` (the weight
publisher's state) goes into ``state.npz`` beside the state's leaves,
under a key the manifest names (``NPZ_REF``): JAX's ``save`` hands such
an array to ``json.dump`` and fails (ROADMAP C.13), and its ``restore``
reads only the state's keys, so it still restores the port's
checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import _ARENA_FIELDS, GradArena, ring_version


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a container, None for a leaf."""
    if isinstance(node, GradArena):
        return [("." + f, getattr(node, f)) for f in _ARENA_FIELDS]
    if isinstance(node, tuple) and hasattr(node, "_fields"):   # NamedTuple
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"checkpoint leaf {prefix!r} is a "
                            f"{type(tree).__name__}, not a tensor")
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += _flatten_with_paths(child, f"{prefix}/{part}" if prefix
                                   else part)
    return out


def _rebuild(tree, leaves):
    """``tree`` with each tensor leaf replaced by the next of the
    iterator ``leaves`` (the order of ``_flatten_with_paths``)."""
    if tree is None:
        return None
    if isinstance(tree, GradArena):
        vals = {f: _rebuild(getattr(tree, f), leaves) for f in _ARENA_FIELDS}
        return GradArena(**vals, phase=tree.phase)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16: a bf16 state leaf cannot "
                        "be written to the npz checkpoint")
    return t.detach().cpu().numpy()


# an array of ``extra`` (the publisher's ring, its scale bits and publish
# steps) is saved in state.npz under "extra:<path>" and stands in the
# manifest as {NPZ_REF: that key}: JSON holds no array, and a restore of
# either package reads only the keys of its state template
NPZ_REF = "__npz__"


def _split_extra(extra, arrays: Dict[str, np.ndarray], path: str = "extra:"):
    """``extra`` with each numpy array moved into ``arrays``."""
    if isinstance(extra, np.ndarray):
        arrays[path] = extra
        return {NPZ_REF: path}
    if isinstance(extra, dict):
        return {k: _split_extra(v, arrays, f"{path}/{k}")
                for k, v in extra.items()}
    return extra


def _join_extra(extra, data):
    """The inverse of ``_split_extra`` against the loaded npz."""
    if isinstance(extra, dict):
        if set(extra) == {NPZ_REF}:
            return np.array(data[extra[NPZ_REF]])
        return {k: _join_extra(v, data) for k, v in extra.items()}
    return extra


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    return _write(ckpt_dir, step,
                  {k: _numpy(v) for k, v in _flatten_with_paths(state)},
                  extra, keep)


def save_sharded(ckpt_dir: str, step: int, state, specs: Dict[str, Any],
                 mesh, ranks, extra: Optional[Dict] = None,
                 keep: int = 3) -> str:
    """``save`` of a state whose leaves named in ``specs`` (checkpoint
    path -> ``dist.sharding.Spec`` or ``tensor_parallel.Segments``,
    ``ambdg.shard_specs``) each rank holds a shard of under the
    multi-rank ``mesh`` (a MeshConfig;
    ``ranks`` its ``dist.collectives.Ranks``; on the per-rank gossip
    the sizes ``{"worker": n}`` and the ``WorkerGroup``); the other
    leaves are whole on every rank. A collective: every rank calls it. Each rank
    writes its shards to ``<dir>/shards.<step>/<rank>.npz``; rank 0
    joins them in host memory, each at the block ``local_shard`` cuts,
    and writes the checkpoint ``save`` writes of the whole state. No
    card holds more than its own shard; rank 0's host holds the whole
    state while it writes. Returns the checkpoint's path."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import dim_shard, local_shard
    from repro_torch.dist.tensor_parallel import Segments
    rank, world = dist.get_rank(), dist.get_world_size()
    parts = os.path.join(ckpt_dir, f"shards.{step}")
    os.makedirs(parts, exist_ok=True)
    leaves = dict(_flatten_with_paths(state))
    np.savez(os.path.join(parts, f"{rank}.npz"),
             **{k: _numpy(leaves[k]) for k in specs})
    dist.barrier()
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if rank == 0:
        flat = {k: _numpy(v) for k, v in leaves.items() if k not in specs}
        files = [np.load(os.path.join(parts, f"{r}.npz"))
                 for r in range(world)]
        for k, spec in specs.items():
            local = leaves[k]
            if isinstance(spec, Segments):
                # one block of each model coordinate, in its order
                by_m = {}
                for r, f in enumerate(files):
                    by_m.setdefault(ranks.coords_of(r)["model"], f)
                flat[k] = spec.join([torch.from_numpy(by_m[m][k]) for m
                                     in range(len(by_m))]).numpy()
                continue
            entries = tuple(spec) + (None,) * (local.dim() - len(spec))
            whole = torch.empty([n * dim_shard(e, mesh) for n, e in
                                 zip(local.shape, entries)],
                                dtype=local.dtype)
            for r, f in enumerate(files):
                local_shard(whole, spec, mesh, ranks.coords_of(r)).copy_(
                    torch.from_numpy(f[k]))
            flat[k] = whole.numpy()
        for f in files:
            f.close()
        final = _write(ckpt_dir, step, flat, extra, keep)
        shutil.rmtree(parts)
    dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           extra: Optional[Dict], keep: int) -> str:
    """Write the leaves ``flat`` (path -> array) and ``extra`` as the
    checkpoint of ``step``, atomically, keeping the ``keep`` latest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    extra_arrays: Dict[str, np.ndarray] = {}
    extra = _split_extra(extra or {}, extra_arrays)
    np.savez(os.path.join(tmp, "state.npz"), **flat, **extra_arrays)
    manifest = {"step": int(step), "keys": sorted(flat), "extra": extra}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic publish
    _apply_retention(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> List[str]:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if re.fullmatch(r"step_\d+", d))


def _apply_retention(ckpt_dir: str, keep: int):
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _steps(ckpt_dir)
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def _migrate_ring_v1(data, template_keys) -> Dict[str, np.ndarray]:
    """Delay-ring layout v1 -> v2, at the numpy level. A v2 template asks
    for per-slot keys ``<p>.ring/<k>`` (tau + 1 of them) where a v1
    checkpoint holds one stacked ``<p>.ring`` of tau slots and a head.
    v2 pops slot 1 first, so the i-th oldest v1 entry ``ring[(head + i)
    % tau]`` becomes v2 slot ``1 + i``; slot 0, the first push target,
    is zeroed; counts and scales permute alike and the head resets to
    0 (the permutation of ``arena.convert_ring``). Returns an overlay
    consulted before the file."""
    out: Dict[str, np.ndarray] = {}
    prefixes = {k[:-len("ring/0")] for k in template_keys
                if re.search(r"\.ring/\d+$", k)}
    for prefix in prefixes:
        if f"{prefix}ring" not in data:       # not a v1 checkpoint
            continue
        ring = data[f"{prefix}ring"]
        counts = data[f"{prefix}counts"]
        head = int(data[f"{prefix}head"])
        tau = ring.shape[0]
        perm = [(head + i) % tau for i in range(tau)]
        out[f"{prefix}ring/0"] = np.zeros_like(ring[0])
        new_counts = np.zeros((tau + 1,) + counts.shape[1:], counts.dtype)
        for i, k in enumerate(perm):
            out[f"{prefix}ring/{1 + i}"] = ring[k]
            new_counts[1 + i] = counts[k]
        if f"{prefix}scales" in data:
            scales = data[f"{prefix}scales"]
            out[f"{prefix}scales/0"] = np.ones_like(scales[0])
            for i, k in enumerate(perm):
                out[f"{prefix}scales/{1 + i}"] = scales[k]
        out[f"{prefix}counts"] = new_counts
        out[f"{prefix}head"] = np.zeros_like(data[f"{prefix}head"])
    return out


def _migrate_variable_ring_v2(data, keys) -> Dict[str, np.ndarray]:
    """The delay-tolerant ring saved as a per-slot tuple -> the stacked
    v3 layout. A v3 template asks for one stacked ``<p>.ring`` where
    such a checkpoint holds ``<p>.ring/<k>`` and the ``.due`` tags (a
    fixed v1 checkpoint also holds a stacked ``.ring`` and must not
    match). Slot k of the tuple is row k of the stack; scales stack
    alike. Returns an overlay consulted before the file."""
    out: Dict[str, np.ndarray] = {}
    for key in keys:
        m = re.fullmatch(r"(.*\.)(ring|scales)", key)
        if not m or key in data:
            continue
        prefix = m.group(1)
        if f"{prefix}due" not in data or f"{key}/0" not in data:
            continue                          # not a tuple-variable ckpt
        n_slots = data[f"{prefix}due"].shape[0]
        out[key] = np.stack([data[f"{key}/{k}"] for k in range(n_slots)])
    return out


def _migrate_decentralized_residual(data, paths) -> Dict[str, np.ndarray]:
    """A ``DecentralizedState`` saved before it held the int8 gossip's
    error-feedback ``residual`` lacks the ``.residual`` key. A zero
    residual is the state every compression="none" run carries (and
    error feedback's cold start), so such a checkpoint restores with a
    zero overlay and continues bit for bit. Only the top-level
    ``.residual`` is made up (an arena's ``.arena.residual`` is always
    saved). Returns an overlay consulted before the file."""
    out: Dict[str, np.ndarray] = {}
    for key, leaf in paths:
        if key == ".residual" and key not in data and ".z" in data:
            out[key] = np.zeros(tuple(leaf.shape),
                                _torch_dtype_to_numpy(leaf.dtype))
    return out


def _torch_dtype_to_numpy(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def sync_ring_phase(tree):
    """Re-derive each v2/v3 arena's host-side ``phase`` from its restored
    ``head`` (the saved schedule position); other nodes as they are."""
    if isinstance(tree, GradArena):
        if ring_version(tree) in (2, 3):
            return tree._replace(phase=int(tree.head) % len(tree.ring))
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[sync_ring_phase(getattr(tree, f))
                            for f in tree._fields])
    if isinstance(tree, dict):
        return {k: sync_ring_phase(v) for k, v in tree.items()}
    return tree


def restore(ckpt_dir: str, state_template, step: Optional[int] = None,
            shard=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``state_template``: each leaf is
    checked against its template leaf's shape, cast to its dtype and
    placed on its device. ``shard=(specs, mesh, coords)``: the template
    is a rank's under a multi-rank mesh, and each leaf named in
    ``specs`` (as ``save_sharded`` takes them) is cut from the whole
    leaf in the file (``local_shard`` at ``coords``) on the host, so
    only the rank's shard reaches its device. Returns (state, the
    manifest's ``extra``)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as data:
        paths = _flatten_with_paths(state_template)
        keys = [k for k, _ in paths]
        migrated = _migrate_ring_v1(data, keys)
        migrated.update(_migrate_variable_ring_v2(data, keys))
        migrated.update(_migrate_decentralized_residual(data, paths))
        leaves = []
        for key, leaf in paths:
            arr = migrated[key] if key in migrated else data[key]
            if shard is not None and key in shard[0]:
                from repro_torch.dist.tensor_parallel import shard_leaf
                specs, mesh, coords = shard
                arr = shard_leaf(torch.from_numpy(arr), specs[key], mesh,
                                 coords).numpy()
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            arr = arr.astype(_torch_dtype_to_numpy(leaf.dtype))
            leaves.append(torch.from_numpy(arr).to(leaf.device))
        extra = _join_extra(manifest["extra"], data)
    restored = _rebuild(state_template, iter(leaves))
    return sync_ring_phase(restored), extra
