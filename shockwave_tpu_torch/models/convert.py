"""Carry the JAX models' parameters over to the port's models.

Each function takes a tree of the JAX package's variables as nested dicts
of arrays (numpy, or anything ``np.asarray`` reads) and returns a
``state_dict`` for the port's model. Flax Dense kernels are [in, out] and
``nn.Linear.weight`` is [out, in]; flax conv kernels are HWIO and
``nn.Conv2d.weight`` is OIHW; flax's ``ConvTranspose`` kernel HWIO is the
port's [in, out, kh, kw]. Nothing here imports JAX: the caller hands over
plain arrays. The same functions carry a gradient tree over (pass the
gradient of ``params``; a family with running statistics then leaves them
out).

- ``params_from_jax``: the TransformerLM (dense or MoE MLP, blocks flat or
  in ``remat_group`` groups), whole or a model-parallel rank's share.
- ``pipelined_params_from_jax``: ``parallel/pipeline.py::PipelinedLM``'s.
- ``resnet_params_from_jax``, ``lstm_lm_params_from_jax``,
  ``neumf_params_from_jax``, ``a3c_params_from_jax``,
  ``cyclegan_params_from_jax``: the other families;
  ``family_params_from_jax`` picks one by the training program's name.
"""

from __future__ import annotations

import numpy as np
import torch

_ATTENTION = ("query", "key", "value", "out")
_MLP = ("in", "out")
# Flax module name -> the port's attribute ("in" is a Python keyword).
_RENAME = {"in": "in_"}


def _array(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def _dense_weight(leaf) -> torch.Tensor:
    return _array(leaf).t().contiguous()


def _conv_weight(leaf) -> torch.Tensor:
    return _array(leaf).permute(3, 2, 0, 1).contiguous()


def _linear(state: dict, prefix: str, tree) -> None:
    state[f"{prefix}.weight"] = _dense_weight(tree["kernel"])
    state[f"{prefix}.bias"] = _array(tree["bias"])


def _conv(state: dict, prefix: str, tree) -> None:
    state[f"{prefix}.weight"] = _conv_weight(tree["kernel"])
    if "bias" in tree:
        state[f"{prefix}.bias"] = _array(tree["bias"])


def _block_params(state: dict, prefix: str, value) -> None:
    for ln in ("ln1", "ln2"):
        state[f"{prefix}.{ln}.weight"] = _array(value[ln]["scale"])
        state[f"{prefix}.{ln}.bias"] = _array(value[ln]["bias"])
    for name in _ATTENTION:
        state[f"{prefix}.attention.{name}.weight"] = _dense_weight(
            value["attention"][name]["kernel"])
    if "moe" in value:
        moe = value["moe"]
        state[f"{prefix}.moe.router.weight"] = _dense_weight(
            moe["router"]["kernel"])
        state[f"{prefix}.moe.w_in"] = _array(moe["w_in"])
        state[f"{prefix}.moe.w_out"] = _array(moe["w_out"])
    elif "mlp" in value:
        for name in _MLP:
            state[f"{prefix}.mlp.{_RENAME.get(name, name)}.weight"] = (
                _dense_weight(value["mlp"][name]["kernel"]))
    else:
        raise ValueError(f"{prefix} has neither 'mlp' nor 'moe'")


def params_from_jax(tree, model_index: int = 0,
                    model_parallel: int = 1) -> dict:
    """The port's state_dict for the JAX TransformerLM ``params`` tree. A
    ``remat_group`` tree (``group_g/block_i``) maps to the flat block
    ``g * group + i``. With ``model_parallel`` M > 1, rank
    ``model_index``'s share of it over a gang's model axis (the JAX
    model's "model" annotations: heads, MLP columns, vocabulary rows and
    experts; ``models/transformer.py::shard_state``)."""
    state = _whole_params_from_jax(tree)
    if model_parallel == 1:
        return state
    from shockwave_tpu_torch.models.transformer import shard_state

    return shard_state(state, model_index, model_parallel)


def _whole_params_from_jax(tree) -> dict:
    state = {"embedding": _array(tree["embedding"])}
    if "positional" in tree:
        state["positional"] = _array(tree["positional"])
    for key, value in tree.items():
        if key in ("embedding", "positional"):
            continue
        if key == "ln_f":
            state["ln_f.weight"] = _array(value["scale"])
            state["ln_f.bias"] = _array(value["bias"])
        elif key.startswith("block_"):
            _block_params(state, f"blocks.{int(key[len('block_'):])}", value)
        elif key.startswith("group_"):
            g = int(key[len("group_"):])
            for name, block in value.items():
                i = g * len(value) + int(name[len("block_"):])
                _block_params(state, f"blocks.{i}", block)
        else:
            raise ValueError(f"unexpected parameter group {key!r}")
    return state


def _batch_norm(state: dict, prefix: str, params, stats) -> None:
    state[f"{prefix}.weight"] = _array(params["scale"])
    state[f"{prefix}.bias"] = _array(params["bias"])
    if stats is not None:
        state[f"{prefix}.running_mean"] = _array(stats["mean"])
        state[f"{prefix}.running_var"] = _array(stats["var"])


def resnet_params_from_jax(params, batch_stats=None) -> dict:
    """ResNet-18/50: flax's ``Conv_0``/``BatchNorm_0`` stem, its blocks
    (``BasicBlock_k`` or ``Bottleneck_k``) and ``Dense_0``; the running
    statistics from ``batch_stats`` when given."""
    state = {}
    _conv(state, "stem", params["Conv_0"])
    _batch_norm(state, "stem_bn", params["BatchNorm_0"],
                None if batch_stats is None else batch_stats["BatchNorm_0"])
    _linear(state, "head", params["Dense_0"])
    for key, block in params.items():
        if "Block" not in key and "Bottleneck" not in key:
            continue
        k = int(key.rsplit("_", 1)[1])
        stats = None if batch_stats is None else batch_stats[key]
        for name, leaf in block.items():
            kind, i = name.rsplit("_", 1)
            if kind == "Conv":
                _conv(state, f"blocks.{k}.convs.{i}", leaf)
            else:
                _batch_norm(state, f"blocks.{k}.bns.{i}", leaf,
                            None if stats is None else stats[name])
    return state


def lstm_lm_params_from_jax(params) -> dict:
    """The LSTM LM: flax's per-gate kernels (i, f, g, o) stacked into
    ``nn.LSTM``'s [4H, in] and [4H, H]; the input bias is zero."""
    cell = params["OptimizedLSTMCell_0"]
    gates = "ifgo"
    hidden_bias = torch.cat([_array(cell[f"h{g}"]["bias"]) for g in gates])
    state = {
        "embed.weight": _array(params["Embed_0"]["embedding"]),
        "lstm.weight_ih_l0": torch.cat(
            [_dense_weight(cell[f"i{g}"]["kernel"]) for g in gates]),
        "lstm.weight_hh_l0": torch.cat(
            [_dense_weight(cell[f"h{g}"]["kernel"]) for g in gates]),
        "lstm.bias_ih_l0": torch.zeros_like(hidden_bias),
        "lstm.bias_hh_l0": hidden_bias,
    }
    _linear(state, "head", params["Dense_0"])
    return state


def neumf_params_from_jax(params) -> dict:
    state = {f"{name}.weight": _array(params[name]["embedding"])
             for name in ("gmf_user", "gmf_item", "mlp_user", "mlp_item")}
    for i in range(3):
        _linear(state, f"mlp.{i}", params[f"Dense_{i}"])
    _linear(state, "out", params["Dense_3"])
    return state


def a3c_params_from_jax(params) -> dict:
    state = {}
    _conv(state, "conv1", params["Conv_0"])
    _conv(state, "conv2", params["Conv_1"])
    for i, name in enumerate(("fc", "policy", "value")):
        _linear(state, name, params[f"Dense_{i}"])
    return state


def cyclegan_params_from_jax(variables) -> dict:
    """``{"gen": {"params": ...}, "disc": {"params": ...}}`` (the JAX
    program's variables, or their gradient)."""
    gen, disc = variables["gen"]["params"], variables["disc"]["params"]
    state = {}
    for key, leaf in gen.items():
        if key == "ConvTranspose_0":
            state["gen.up.weight"] = _array(leaf["kernel"]).permute(
                2, 3, 0, 1).contiguous()
            state["gen.up.bias"] = _array(leaf["bias"])
        else:
            _conv(state, f"gen.convs.{int(key[len('Conv_'):])}", leaf)
    for key, leaf in disc.items():
        _conv(state, f"disc.convs.{int(key[len('Conv_'):])}", leaf)
    return state


def family_params_from_jax(family: str, variables) -> dict:
    """The state_dict of the training program's ``family`` model from the
    JAX program's variables (``build_family``'s first value, unboxed):
    ``{"params": ...}``, with ``"batch_stats"`` for ResNet, or CycleGAN's
    ``{"gen": ..., "disc": ...}``."""
    if family == "CycleGAN":
        return cyclegan_params_from_jax(variables)
    params = variables["params"]
    if family in ("ResNet-18", "ResNet-50"):
        return resnet_params_from_jax(params, variables.get("batch_stats"))
    convert = {"Transformer": params_from_jax, "LM": lstm_lm_params_from_jax,
               "Recommendation": neumf_params_from_jax,
               "A3C": a3c_params_from_jax}[family]
    return convert(params)


def pipelined_params_from_jax(params) -> dict:
    """``parallel/pipeline.py::PipelinedLM``'s parameters for the JAX
    ``PipelinedLM``'s: each ``blocks`` leaf [S, L, ...] maps to the port's
    Block parameter of that name, [S, L, ...] in the port's layout."""
    blocks = params["blocks"]
    S, L = np.shape(blocks["ln1"]["scale"])[:2]
    drawn = []
    for s in range(S):
        for i in range(L):
            state = {}
            _block_params(state, "b", _index_tree(blocks, (s, i)))
            drawn.append({k[len("b."):]: v for k, v in state.items()})
    out = {"blocks": {name: torch.stack([d[name] for d in drawn]).reshape(
        (S, L) + drawn[0][name].shape) for name in drawn[0]}}
    for key in ("embedding", "ln_f_scale", "ln_f_bias", "positional"):
        if key in params:
            out[key] = _array(params[key])
    return out


def _index_tree(tree, index):
    if isinstance(tree, dict):
        return {k: _index_tree(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]
