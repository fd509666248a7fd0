"""The JAX package's LM parameters as the port's module state.

`params_from_jax(tree, cfg)` takes the tree `repro.models.lm.init_params`
builds, as numpy arrays (`jax.tree.map(np.asarray, params)`): nested
dicts whose segment leaves (`blocks`; an MoE config's `dense_blocks`;
the hybrid's `groups` and `tail`) are stacked over the segment's layers,
each segment's count checked against the config's
(`lm.segment_layers`). It returns the state dict of the port's `LM` for
the same config — the same names with the layer index after the segment
(`blocks.3.attn.wq` is `tree["blocks"]["attn"]["wq"][3]`,
`groups.2.rec1.rec.w_i` is `tree["groups"]["rec1"]["rec"]["w_i"][2]`,
MLA's `dense_blocks.0.attn.q_norm.scale` is `tree["dense_blocks"]
["attn"]["q_norm"]["scale"][0]`), the same layouts (wq (d, H, hd), the
tied `embed.table` over the padded vocab, `blocks.1.moe.w_in` (E, d,
F), `blocks.0.ssm.w_in` (d, 2 d_in + 2 N + H), MLA's `w_uq` (q_lora, H,
nope + rope)) and the same dtypes (an MoE router, the SSM's `a_log`,
`dt_bias`, `d_skip` and the RG-LRU's `lam` stay fp32 beside bf16
leaves):

    model = lm.init_params(cfg, dtype=..., device=...)
    model.load_state_dict(params_from_jax(tree, cfg))

`opt_state_from_jax(opt_tree, cfg)` maps JAX's AdamW state
(`repro.optim.adamw_init` / `adamw_update`: {"mu", "nu", "step"}, as
numpy) onto the port's (`repro_torch.optim.adamw_init`): mu and nu by
the same names as the parameters, step an int32 scalar tensor.

`params_to_jax(state, cfg)` and `opt_state_to_jax(opt, cfg)` are the
inverse maps: the per-layer leaves stacked back over each segment's
layers (their counts checked against the config's), names split into
JAX's nested dicts, as torch tensors (bf16 stays bf16), so that
`params_to_jax(params_from_jax(t, cfg), cfg)` is `t` bit for bit. The
checkpoint store writes this layout (`checkpoint.store.stack_layers`).

The port's tests use them to make both packages compute one function.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint.store import layer_of, stack_layers
from repro_torch.models.lm import segment_layers


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch twin
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    layers = segment_layers(cfg)
    state: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            t = _tensor(val)
            if not path or path[0] not in layers:
                state[".".join(path + (key,))] = t
                continue
            n = layers[path[0]]
            if t.shape[0] != n:
                raise ValueError(f"{'.'.join(path + (key,))}: {t.shape[0]} "
                                 f"layers stacked, the config has {n}")
            for i in range(n):
                state[".".join((path[0], str(i)) + path[1:] + (key,))] = \
                    t[i].clone()

    walk(tree, ())
    return state


def opt_state_from_jax(opt_tree, cfg):
    return {"mu": params_from_jax(opt_tree["mu"], cfg),
            "nu": params_from_jax(opt_tree["nu"], cfg),
            "step": torch.as_tensor(np.array(opt_tree["step"]),
                                    dtype=torch.int32)}


def params_to_jax(state: Dict[str, torch.Tensor], cfg) -> dict:
    layers = segment_layers(cfg)
    counts: Dict[str, set] = {}
    for name in state:
        path, i = layer_of(name)
        if i is not None:
            counts.setdefault(path[0], set()).add(i)
    for seg, idx in counts.items():
        if len(idx) != layers.get(seg):
            raise ValueError(f"{seg}: {len(idx)} layers, the config has "
                             f"{layers.get(seg)}")
    return stack_layers(dict(state), torch.stack)


def opt_state_to_jax(opt, cfg) -> dict:
    return {"mu": params_to_jax(opt["mu"], cfg),
            "nu": params_to_jax(opt["nu"], cfg),
            "step": opt["step"]}
