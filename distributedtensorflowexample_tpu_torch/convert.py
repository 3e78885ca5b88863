"""The weight bridge between the JAX package and the port.

Turns a flax ``MnistCNN`` param tree (nested dicts of numpy arrays) and
its optax momentum trace into the port's layouts, and back, moving
weights without changing a value:

- conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``);
- dense kernels ``[in, out]`` -> ``[out, in]``;
- biases unchanged.

The feature order of ``fc1``'s input needs no permutation: the port's
``MnistCNN`` flattens its activation in NHWC order, as flax does.

The momentum comes either as a params-shaped tree (``optax.sgd``'s
``TraceState.trace``) or as the Pallas fused optimizer's flat
``FusedSgdState.trace``: a ``(rows, 128)`` float32 buffer holding the
leaves raveled and concatenated in ``jax.tree.flatten`` order (dict keys
sorted at every level), zero-padded at the end.
"""

from __future__ import annotations

import numpy as np

_LANES = 128


def _to_port(key: str, leaf: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    x = np.asarray(x)
    if leaf == "bias":
        return f"{key}.bias", x
    if x.ndim == 4:                                   # HWIO -> OIHW
        return f"{key}.weight", np.ascontiguousarray(x.transpose(3, 2, 0, 1))
    return f"{key}.weight", np.ascontiguousarray(x.T)  # [in,out] -> [out,in]


def flax_to_port(tree: dict) -> dict[str, np.ndarray]:
    """flax ``{"conv1": {"kernel", "bias"}, ...}`` -> port
    ``{"conv1.weight", "conv1.bias", ...}`` (numpy, port layouts)."""
    return dict(_to_port(key, leaf, x)
                for key, sub in tree.items() for leaf, x in sub.items())


def port_to_flax(state: dict) -> dict:
    """Inverse of :func:`flax_to_port`."""
    out: dict = {}
    for name, x in state.items():
        key, kind = name.rsplit(".", 1)
        x = np.asarray(x)
        if kind == "bias":
            leaf, y = "bias", x
        elif x.ndim == 4:                              # OIHW -> HWIO
            leaf, y = "kernel", np.ascontiguousarray(x.transpose(2, 3, 1, 0))
        else:
            leaf, y = "kernel", np.ascontiguousarray(x.T)
        out.setdefault(key, {})[leaf] = y
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


def load_into_state(state, params: dict, momentum: dict | None = None
                    ) -> None:
    """Copy a flax param tree (and optionally a params-shaped momentum
    tree) into a port ``TrainState``, in place — the values land in the
    optimizer's flat buffers, which the model's parameters view."""
    import torch
    named = dict(state.model.named_parameters())
    with torch.no_grad():
        for name, x in flax_to_port(params).items():
            named[name].copy_(torch.from_numpy(x))
        if momentum is not None:
            views = state.optimizer.views(state.optimizer.momentum_flat)
            for name, x in flax_to_port(momentum).items():
                views[name].copy_(torch.from_numpy(x))


def state_to_flax(state) -> tuple[dict, dict | None]:
    """(params tree, momentum tree or None) of a port ``TrainState``, as
    numpy copies in flax layouts."""
    copy = lambda t: t.detach().cpu().numpy().copy()
    params = {n: copy(p) for n, p in state.model.named_parameters()}
    opt = state.optimizer
    momentum = None
    if opt.momentum_flat is not None:
        momentum = port_to_flax({n: copy(v) for n, v in
                                 opt.views(opt.momentum_flat).items()})
    return port_to_flax(params), momentum
