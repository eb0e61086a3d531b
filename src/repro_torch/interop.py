"""Moving parameter trees between the JAX reference and the port.

Both directions go through numpy: the reference's arrays become numpy
arrays (``np.asarray``), and a nested dict of numpy arrays becomes a
nested dict of tensors. The same goes for a whole train state (params,
optimizer moments and the int32 step), which checkpoints and the
cross-framework tests carry over. Leaf order and names are the reference's
(``repro_torch.tree``), so leaf ``i`` of one side is leaf ``i`` of the
other.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .tree import leaves_with_names, map_leaves


def _to_tensor(a: Any, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16; widen exactly
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(np_tree: Any, device: str | torch.device = "cpu",
                          dtype: torch.dtype | None = None) -> Any:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    nested dict of tensors on ``device``, cast to ``dtype`` when given."""
    dev = torch.device(device)
    return map_leaves(lambda a: _to_tensor(a, dev, dtype), np_tree)


def params_to_reference(tree: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays on the host.
    bfloat16 leaves come back as float32, since numpy has no bfloat16."""

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_leaves(to_np, tree)


def state_from_reference(np_state: dict, device: str | torch.device = "cpu") -> dict:
    """The reference's train state ``{"step", "params", "opt"}`` (arrays or
    numpy) -> the port's, on ``device``, every leaf in its own dtype (the
    step an int32 0-d tensor)."""
    if set(np_state) != {"step", "params", "opt"}:
        raise ValueError(f"not a train state: keys {sorted(np_state)}")
    return params_from_reference(np_state, device)


def state_to_reference(state: dict) -> dict:
    """The port's train state -> nested dict of numpy arrays with the
    reference's structure, ready for ``jax.tree.map(jnp.asarray, ...)``."""
    if set(state) != {"step", "params", "opt"}:
        raise ValueError(f"not a train state: keys {sorted(state)}")
    return params_to_reference(state)


def leaf_names(tree: Any) -> list[str]:
    """``jax.tree_util.keystr`` names of the leaves, in flatten order."""
    return [name for name, _ in leaves_with_names(tree)]
