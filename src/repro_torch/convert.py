"""Parameter and carry conversion between the JAX package and the port.

The JAX package's dyngnn parameter tree (nested dicts/lists of ``w/b``,
``wx/wh/b``, ``w0``, ``classifier.u/b``) maps one to one onto the port's
:class:`~repro_torch.core.models.ParamTree`; its LM tree (``embed``,
stacked ``layers.attn/ffn/ln1/ln2``, ``final_norm``, ``out``) onto the
same nested dict of tensors.  Both directions take and give numpy arrays,
so this module imports neither ``jax`` nor ``repro``: the caller converts
with ``jax.tree.map(np.asarray, params)`` first.  bfloat16 arrays (numpy's
``ml_dtypes`` extension type) cross bit-exactly through their 16-bit
pattern.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.models import ParamTree


def _tensor(arr: Any) -> torch.Tensor:
    """numpy array -> CPU tensor (a copy); bfloat16 by its bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return _tensor(tree)


def params_from_jax(tree: dict) -> ParamTree:
    """A JAX parameter tree as numpy arrays -> the port's ``ParamTree`` (on
    the CPU; move it with ``.to(device)``).  Works for all three models."""
    return ParamTree(_numpy_tree(tree))


def lm_params_from_jax(tree: dict) -> dict:
    """A JAX LM parameter tree (``repro.models.lm.init_lm_params``) as
    numpy arrays -> the same nested dict of CPU tensors, the tree
    ``repro_torch.models.lm`` takes."""
    return _numpy_tree(tree)


def params_to_numpy(params: ParamTree) -> dict[str, np.ndarray]:
    """``state_dict`` keys (``layers.0.gcn.w`` ...) -> numpy arrays."""
    return {k: v.detach().cpu().numpy()
            for k, v in params.state_dict().items()}


def carries_from_jax(tree: Any, device="cpu") -> Any:
    """JAX carries as numpy (tuples / lists of arrays) -> tensors of the
    same nesting (tuples stay tuples, lists stay lists)."""
    if isinstance(tree, tuple):
        return tuple(carries_from_jax(v, device) for v in tree)
    if isinstance(tree, list):
        return [carries_from_jax(v, device) for v in tree]
    return _tensor(tree).to(device)


def carries_to_numpy(carries: Any) -> Any:
    """The port's carries -> numpy arrays of the same nesting, the form
    ``jax.tree.map(np.asarray, carries)`` gives for the JAX package's."""
    if isinstance(carries, tuple):
        return tuple(carries_to_numpy(v) for v in carries)
    if isinstance(carries, list):
        return [carries_to_numpy(v) for v in carries]
    return carries.detach().cpu().numpy()


def opt_state_from_jax(state: dict) -> dict:
    """A JAX AdamW state (``repro.optim.adamw.init_state``'s tree as numpy
    arrays) -> the port's: ``m`` / ``v`` / ``master`` keyed by the
    ``ParamTree`` parameter names in its order, ``step`` a 0-d int32
    tensor on the host."""
    names = [k for k, _ in ParamTree(_numpy_tree(state["m"]))
             .named_parameters()]

    def flat(tree) -> dict:
        module = ParamTree(_numpy_tree(tree))
        got = dict(module.named_parameters())
        return {k: got[k].detach() for k in names}

    return {"m": flat(state["m"]), "v": flat(state["v"]),
            "master": flat(state["master"]),
            "step": torch.as_tensor(np.asarray(state["step"]),
                                    dtype=torch.int32)}
