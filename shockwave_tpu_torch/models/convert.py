"""Carry the JAX model's parameters over to the port's TransformerLM.

``params_from_jax(tree)`` takes the JAX package's ``variables["params"]``
as a nested dict of arrays (numpy, or anything ``np.asarray`` reads)
and returns a ``state_dict`` for
:class:`shockwave_tpu_torch.models.transformer.TransformerLM`. Flax Dense
kernels are [in, out] and ``nn.Linear.weight`` is [out, in], so they are
transposed. Nothing here imports JAX: the caller hands over plain arrays.
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = {
    "attention": ("query", "key", "value", "out"),
    "mlp": ("in", "out"),
}
# Flax module name -> the port's attribute ("in" is a Python keyword).
_RENAME = {"in": "in_"}


def _array(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def params_from_jax(tree) -> dict:
    """The port's state_dict for the JAX TransformerLM ``params`` tree."""
    state = {"embedding": _array(tree["embedding"])}
    if "positional" in tree:
        state["positional"] = _array(tree["positional"])
    for key, value in tree.items():
        if key in ("embedding", "positional"):
            continue
        if key == "ln_f":
            state["ln_f.weight"] = _array(value["scale"])
            state["ln_f.bias"] = _array(value["bias"])
            continue
        if not key.startswith("block_"):
            raise ValueError(f"unexpected parameter group {key!r}")
        prefix = f"blocks.{int(key[len('block_'):])}"
        for ln in ("ln1", "ln2"):
            state[f"{prefix}.{ln}.weight"] = _array(value[ln]["scale"])
            state[f"{prefix}.{ln}.bias"] = _array(value[ln]["bias"])
        for module, names in _DENSE.items():
            if module not in value:
                raise ValueError(f"{key} has no {module!r} (MoE is not ported)")
            for name in names:
                kernel = _array(value[module][name]["kernel"])
                attr = _RENAME.get(name, name)
                state[f"{prefix}.{module}.{attr}.weight"] = kernel.t().contiguous()
    return state
