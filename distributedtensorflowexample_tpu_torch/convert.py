"""The weight bridge between the JAX package and the port.

Turns a flax param tree (nested dicts of numpy arrays, any depth) and
its optax momentum trace into the port's layouts, and back, moving
weights without changing a value.  Each flax leaf is mapped by its name:

- ``kernel``: conv HWIO -> OIHW (``transpose(3, 2, 0, 1)``), dense
  ``[in, out]`` -> ``[out, in]``, both to ``weight``;
- ``embedding``: copied as is to ``weight`` (``nn.Embedding.weight`` is
  ``[num, features]`` like flax's table);
- ``scale`` (LayerNorm, BatchNorm) -> ``weight``; ``bias`` -> ``bias``.

A tree path joins with dots: ``block3/ln1/scale`` is ``block3.ln1.weight``.
Going back, a 2-D ``weight`` is a dense kernel unless its module is one
of the ``embeddings`` the caller names (``state_to_flax`` finds them in
the model); a 1-D ``weight`` is a LayerNorm or BatchNorm scale.

The feature order of ``MnistCNN``'s ``fc1`` input needs no permutation:
the port flattens its activation in NHWC order, as flax does.

A model with batch norm (``models/resnet.py``) also has flax's
``batch_stats`` tree, ``{"bn_init": {"mean", "var"}, "stage0_block0":
{"bn1": {...}}, ...}``: its leaves are the port's buffers of the same
dotted name (``stage0_block0.bn1.mean``), copied as they are
(:func:`batch_stats_to_port`, :func:`port_to_batch_stats`).

The JAX package's async state (``parallel/async_ps.make_worker_state``)
is worker-tiled: every leaf has a leading worker axis W.  The port runs
worker w as rank w, so :func:`worker_slice` takes worker w's copy of a
tree, to load into rank w's state.

A batch-norm model in async mode keeps one ``batch_stats`` per worker:
the JAX package tiles it with the parameters, and ``worker_slice`` of
the tiled tree is rank w's buffers (:func:`load_into_state`'s
``batch_stats``).

The ZeRO modes keep state as bucket rows (``parallel/bucketing.py``):
bucket b is a ``[D, W_b]`` layout of its leaves, raveled to ``[D*W_b]``
in the JAX package (``Zero3Layout.init_rows``, the momentum traces of
``init_bucketed_opt_state``), and held as row d on rank d in the port.
The leaves are laid out in each side's own leaf layout (a conv kernel
HWIO in flax, OIHW in the port), so :func:`jax_rows_to_port` and
:func:`port_rows_to_jax` cut the rows into leaves, convert each, and lay
them out again; the plan (bucket membership, widths and padding) is the
same on both sides.

The momentum comes either as a params-shaped tree (``optax.sgd``'s
``TraceState.trace``) or as the Pallas fused optimizer's flat
``FusedSgdState.trace``: a ``(rows, 128)`` float32 buffer holding the
leaves raveled and concatenated in ``jax.tree.flatten`` order (dict keys
sorted at every level: ``block0 ... block7, embed, ln_f, pos`` for the
LM), zero-padded at the end.
"""

from __future__ import annotations

from typing import Collection

import numpy as np

_LANES = 128


def _to_flax(leaf: str, x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_to_port` for a leaf whose flax name is known."""
    x = np.asarray(x)
    if leaf != "kernel":
        return x
    if x.ndim == 4:                                   # OIHW -> HWIO
        return np.ascontiguousarray(x.transpose(2, 3, 1, 0))
    return np.ascontiguousarray(x.T)


def _to_port(leaf: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    x = np.asarray(x)
    if leaf == "bias":
        return "bias", x
    if leaf in ("embedding", "scale"):
        return "weight", x
    if leaf != "kernel":
        raise ValueError(f"unknown flax leaf {leaf!r}")
    if x.ndim == 4:                                   # HWIO -> OIHW
        return "weight", np.ascontiguousarray(x.transpose(3, 2, 0, 1))
    return "weight", np.ascontiguousarray(x.T)       # [in,out] -> [out,in]


def flax_to_port(tree: dict) -> dict[str, np.ndarray]:
    """flax ``{"conv1": {"kernel", "bias"}, "block0": {"ln1": {"scale",
    ...}}, ...}`` -> port ``{"conv1.weight", "block0.ln1.weight", ...}``
    (numpy, port layouts)."""
    out = {}
    for path, x in _flatten_order(tree):
        name, y = _to_port(path[-1], x)
        out[".".join(path[:-1] + (name,))] = y
    return out


def port_to_flax(state: dict, embeddings: Collection[str] = ()) -> dict:
    """Inverse of :func:`flax_to_port`.  ``embeddings``: the dotted names
    of the modules whose ``weight`` is an embedding table."""
    out: dict = {}
    for name, x in state.items():
        key, kind = name.rsplit(".", 1)
        x = np.asarray(x)
        if kind == "bias":
            leaf, y = "bias", x
        elif key in embeddings:
            leaf, y = "embedding", x
        elif x.ndim == 1:
            leaf, y = "scale", x
        elif x.ndim == 4:                              # OIHW -> HWIO
            leaf, y = "kernel", np.ascontiguousarray(x.transpose(2, 3, 1, 0))
        else:
            leaf, y = "kernel", np.ascontiguousarray(x.T)
        node = out
        for k in key.split("."):
            node = node.setdefault(k, {})
        node[leaf] = y
    return out


def batch_stats_to_port(tree: dict) -> dict[str, np.ndarray]:
    """flax ``batch_stats`` -> the port's buffers by dotted name."""
    return {".".join(path): x for path, x in _flatten_order(tree)}


def port_to_batch_stats(buffers: dict) -> dict:
    """Inverse of :func:`batch_stats_to_port`."""
    out: dict = {}
    for name, x in buffers.items():
        *keys, leaf = name.split(".")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(x)
    return out


def _flatten_order(tree: dict, prefix=()) -> list[tuple[tuple, np.ndarray]]:
    """Leaves with their key paths in ``jax.tree.flatten`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten_order(v, prefix + (k,))
        else:
            out.append((prefix + (k,), np.asarray(v)))
    return out


def worker_slice(tree: dict, worker: int) -> dict:
    """Worker ``worker``'s copy of a worker-tiled tree (every leaf
    ``[W, ...]``), as numpy copies."""
    return {k: worker_slice(v, worker) if isinstance(v, dict)
            else np.array(np.asarray(v)[worker], copy=True)
            for k, v in tree.items()}


def _row_plan(params_like: dict, bucket_bytes: int):
    """``(leaves with their flax paths in JAX order, the bucket plan)``."""
    from distributedtensorflowexample_tpu_torch.parallel.bucketing import (
        plan_buckets)
    leaves = _flatten_order(params_like)
    return leaves, plan_buckets([x for _, x in leaves], bucket_bytes)


def _relayout_rows(full: np.ndarray, leaves, idxs, convert) -> np.ndarray:
    """A bucket's ``[D, W]`` rows with every leaf passed through
    ``convert(flax_path, leaf) -> leaf`` (another layout of the same
    elements) and laid out again."""
    d = full.shape[0]
    cols, off = [], 0
    for i in idxs:
        path, like = leaves[i]
        w = -(-like.size // d)
        piece = full[:, off:off + w].reshape(-1)[:like.size]
        out = np.asarray(convert(path, piece)).reshape(-1)
        cols.append(np.pad(out, (0, d * w - out.size)).reshape(d, w))
        off += w
    return np.concatenate(cols, axis=1)


def jax_rows_to_port(rows, params_like: dict, bucket_bytes: int,
                     num_devices: int) -> list[list[np.ndarray]]:
    """The JAX package's bucket rows (one ``[D*W_b]`` array per bucket, of
    the parameters or of a params-shaped moment) -> the port's,
    ``[rank][bucket] -> [W_b]``.  ``params_like``: the flax params tree
    (for the leaves' names and shapes)."""
    leaves, plan = _row_plan(params_like, bucket_bytes)
    shapes = {path: x.shape for path, x in leaves}

    def to_port(path, x):
        return _to_port(path[-1], x.reshape(shapes[path]))[1]

    out = [[None] * len(plan) for _ in range(num_devices)]
    for b, idxs in enumerate(plan):
        full = np.asarray(rows[b], np.float32).reshape(num_devices, -1)
        port = _relayout_rows(full, leaves, idxs, to_port)
        for d in range(num_devices):
            out[d][b] = port[d].copy()
    return out


def port_rows_to_jax(rank_rows, params_like: dict,
                     bucket_bytes: int) -> tuple:
    """Inverse of :func:`jax_rows_to_port`: every rank's rows
    (``[rank][bucket]``) -> one ``[D*W_b]`` array per bucket."""
    leaves, plan = _row_plan(params_like, bucket_bytes)
    shapes = {path: _to_port(path[-1], x)[1].shape for path, x in leaves}

    def to_flax(path, x):
        return _to_flax(path[-1], x.reshape(shapes[path]))

    return tuple(
        _relayout_rows(np.stack([np.asarray(r[b], np.float32)
                                 for r in rank_rows]),
                       leaves, idxs, to_flax).reshape(-1)
        for b, idxs in enumerate(plan))


def flat_trace_rows(num_params: int) -> int:
    """Rows of the flat ``(rows, 128)`` trace for ``num_params``
    parameters: at least 8, a multiple of 8 (the Pallas kernel's tiling)."""
    rows = max(8, -(-num_params // _LANES))
    return -(-rows // 8) * 8


def flat_trace_to_tree(trace: np.ndarray, like: dict) -> dict:
    """Cut a flat ``FusedSgdState.trace`` into a tree shaped like the
    params tree ``like``."""
    flat = np.asarray(trace, np.float32).reshape(-1)
    out: dict = {}
    offset = 0
    for path, leaf in _flatten_order(like):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[offset:offset + leaf.size].reshape(leaf.shape)
        offset += leaf.size
    return out


def tree_to_flat_trace(tree: dict) -> np.ndarray:
    """Inverse of :func:`flat_trace_to_tree`: the padded ``(rows, 128)``
    float32 buffer."""
    leaves = [x.astype(np.float32).reshape(-1)
              for _, x in _flatten_order(tree)]
    flat = np.concatenate(leaves)
    rows = flat_trace_rows(flat.size)
    out = np.zeros(rows * _LANES, np.float32)
    out[:flat.size] = flat
    return out.reshape(rows, _LANES)


def load_into_state(state, params: dict, momentum: dict | None = None,
                    batch_stats: dict | None = None) -> None:
    """Copy a flax param tree (and optionally a params-shaped momentum
    tree and a ``batch_stats`` tree) into a port ``TrainState``, in place
    — the parameters land in the optimizer's flat buffers, which the
    model's parameters view, and the statistics in the model's
    buffers."""
    import torch
    named = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    with torch.no_grad():
        for name, x in flax_to_port(params).items():
            named[name].copy_(torch.from_numpy(x))
        for name, x in batch_stats_to_port(batch_stats or {}).items():
            buffers[name].copy_(torch.from_numpy(np.asarray(x)))
        if momentum is not None:
            views = state.optimizer.views(state.optimizer.momentum_flat)
            for name, x in flax_to_port(momentum).items():
                views[name].copy_(torch.from_numpy(x))


def embedding_modules(model) -> set[str]:
    """The dotted names of ``model``'s ``nn.Embedding`` modules."""
    from torch import nn
    return {n for n, m in model.named_modules() if isinstance(m, nn.Embedding)}


def state_to_flax(state) -> tuple[dict, dict | None]:
    """(params tree, momentum tree or None) of a port ``TrainState``, as
    numpy copies in flax layouts."""
    copy = lambda t: t.detach().cpu().numpy().copy()
    emb = embedding_modules(state.model)
    params = {n: copy(p) for n, p in state.model.named_parameters()}
    opt = state.optimizer
    momentum = None
    if opt.momentum_flat is not None:
        momentum = port_to_flax({n: copy(v) for n, v in
                                 opt.views(opt.momentum_flat).items()}, emb)
    return port_to_flax(params, emb), momentum


def state_batch_stats(state) -> dict:
    """The flax ``batch_stats`` tree of a port ``TrainState`` (numpy
    copies; ``{}`` for a model without batch norm)."""
    return port_to_batch_stats({n: b.detach().cpu().numpy().copy()
                                for n, b in state.model.named_buffers()})
