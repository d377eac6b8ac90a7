"""Carry weights and state across from the JAX reference, given as numpy.

``params_from_jax`` takes the reference ``init_params`` pytree with numpy
leaves and keeps its nesting and the ``x @ W`` layout: ``embed``,
``head``, ``norm_f`` and ``blocks`` stacked on a leading block axis, for
every family the port runs; deepseek's ``first`` (a list of unstacked
layers); the MLA leaves (``w_dq``, ``w_uq``, ``w_dkv``, ``w_uk``,
``w_uv``, ``wo``); the ``moe`` leaves (``router`` f32, the (E, ...)
expert weights, ``shared`` / ``residual``); jamba's ``pos{i}`` layers of
a period; whisper's ``enc`` subtree (stacked encoder ``blocks``,
``norm_f``) and its decoder layers' ``norm_x`` and ``cross`` leaves.  It
carries caches too: dicts and lists of arrays, an ``SSMState`` (the
hybrid family's ``{"attn", "ssm"}`` cache), whisper's ``cross_k`` /
``cross_v``; and the optimizer's ``AdamWState`` (step, f32 moments).
``ssm_state_from_numpy`` carries a (stacked or per-layer) ``SSMState``;
``routing_from_numpy`` and ``pool_from_numpy`` do the same for the
datapath state.  The caller turns
its arrays into numpy; nothing here sees a JAX array.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.balancer import PoolState
from repro_torch.core.routing_table import RoutingState, state_from_numpy
from repro_torch.models.ssm import SSMState
from repro_torch.optim.adamw import AdamWState


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, device, dtype=None):
    """Nested dicts and lists of numpy arrays → the same nesting of
    tensors; a tuple with ``SSMState``'s or ``AdamWState``'s fields
    becomes one (an ``AdamWState``'s step keeps its int32)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == SSMState._fields:
        return SSMState(*(params_from_jax(v, device, dtype) for v in tree))
    if getattr(tree, "_fields", None) == AdamWState._fields:
        return AdamWState(_tensor(tree.step, device),
                          *(params_from_jax(v, device, dtype)
                            for v in tree[1:]))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    return _tensor(tree, device, dtype)


def _fields(obj, names) -> dict:
    """Field-name → array from a mapping or a NamedTuple-like object."""
    if isinstance(obj, dict):
        return {n: obj[n] for n in names}
    return {n: getattr(obj, n) for n in names}


def ssm_state_from_numpy(state, device) -> SSMState:
    """An ``SSMState`` from numpy arrays (a mapping or an object with the
    fields ``ssm`` and ``conv``), dtypes kept."""
    f = _fields(state, SSMState._fields)
    return SSMState(*(_tensor(f[n], device) for n in SSMState._fields))


def routing_from_numpy(arrays, device) -> RoutingState:
    """A ``RoutingState`` from numpy arrays (a mapping or an object with
    the same field names)."""
    return state_from_numpy(_fields(arrays, RoutingState._fields), device)


def pool_from_numpy(arrays, device) -> PoolState:
    """A ``PoolState`` from numpy arrays; ``active`` becomes bool."""
    f = _fields(arrays, PoolState._fields)
    return PoolState(*[_tensor(f[n], device, torch.int32)
                       for n in PoolState._fields[:-1]],
                     _tensor(f["active"], device).ne(0))
