"""Weight bridge: a flax parameter tree -> the port's modules.

``load_flax_params(module, tree)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and fills the port's module, matching by name (the port's submodules carry the
flax names). It is strict on both sides: every leaf of the tree is consumed
exactly once, every torch parameter is set, every shape is checked, and any
mismatch raises before a single parameter is written.

Mappings: Dense ``kernel [in, out]`` -> ``weight [out, in]``; Conv ``kernel
DHWIO`` -> ``weight OIDHW``; LayerNorm ``scale/bias`` -> ``weight/bias``; the
attention's fused ``to_kv`` kernel splits into ``to_k`` (first half of the
output columns) and ``to_v`` (second half); everything else (``pos_encoding``,
``latents``, ``up0/out_kernel``, ``up0/out_bias``) is copied as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from voxactb_tpu_torch.models.blocks import Conv3D, Dense, LayerNorm
from voxactb_tpu_torch.models.perceiver import Attention

Path = Tuple[str, ...]
Target = Tuple[nn.Parameter, Callable[[np.ndarray], np.ndarray]]


def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _dhwio_to_oidhw(a: np.ndarray) -> np.ndarray:
    return a.transpose(4, 3, 0, 1, 2)


def flax_targets(module: nn.Module) -> Dict[Path, List[Target]]:
    """flax leaf path -> the torch parameter(s) it fills and how."""
    targets: Dict[Path, List[Target]] = {}

    def add(path: Path, param: nn.Parameter, fn) -> None:
        targets.setdefault(path, []).append((param, fn))

    def visit(mod: nn.Module, prefix: Path) -> None:
        if isinstance(mod, Dense):
            add(prefix + ("kernel",), mod.weight, _transpose)
            if mod.bias is not None:
                add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, LayerNorm):
            add(prefix + ("scale",), mod.weight, _identity)
            add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, Conv3D):
            add(prefix + ("kernel",), mod.weight, _dhwio_to_oidhw)
            add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, Attention):
            visit(mod.to_q, prefix + ("to_q",))
            visit(mod.to_out, prefix + ("to_out",))
            inner = mod.to_k.weight.shape[0]
            add(prefix + ("to_kv", "kernel"), mod.to_k.weight,
                lambda a: a[:, :inner].T)
            add(prefix + ("to_kv", "kernel"), mod.to_v.weight,
                lambda a: a[:, inner:].T)
            return
        for name, p in mod.named_parameters(recurse=False):
            add(prefix + (name,), p, _identity)
        for name, child in mod.named_children():
            visit(child, prefix + (name,))

    visit(module, ())
    return targets


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    leaves: Dict[Path, np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            leaves.update(_flatten(value, path))
        else:
            leaves[path] = np.asarray(value)
    return leaves


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Fill ``module`` from a flax parameter tree (``{'params': {...}}`` or the
    inner dict). Raises ``ValueError`` on an unexpected, missing or misshapen
    leaf, and on a torch parameter the tree does not set."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    leaves = _flatten(tree)
    targets = flax_targets(module)

    errors = []
    unexpected = sorted(set(leaves) - set(targets))
    missing = sorted(set(targets) - set(leaves))
    errors += [f"unexpected leaf {'/'.join(p)}" for p in unexpected]
    errors += [f"missing leaf {'/'.join(p)}" for p in missing]
    covered = {id(param) for entries in targets.values() for param, _ in entries}
    errors += [f"torch parameter {name} has no flax leaf"
               for name, param in module.named_parameters() if id(param) not in covered]

    writes = []
    for path in sorted(set(leaves) & set(targets)):
        for param, fn in targets[path]:
            value = np.ascontiguousarray(fn(leaves[path]))
            if tuple(value.shape) != tuple(param.shape):
                errors.append(f"shape of {'/'.join(path)}: flax "
                              f"{tuple(leaves[path].shape)} maps to "
                              f"{tuple(value.shape)}, torch {tuple(param.shape)}")
                continue
            writes.append((param, value))
    if errors:
        raise ValueError("flax tree does not match the module:\n  " + "\n  ".join(errors))
    with torch.no_grad():
        for param, value in writes:
            param.copy_(torch.tensor(value, dtype=param.dtype))
