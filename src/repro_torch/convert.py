"""Weights carried between the JAX package and the port.

The LLM trees (``"embed"`` in the tree) carry over key for key: the
reference's nested tree ``{"embed", "layers": {"attn": {"wq", ...}, ...},
"final_norm", "lm_head"}`` becomes the port's flat dict with dotted keys
(``layers.attn.wq``), shapes and (in, out) layouts unchanged. A list in the
tree (the hybrid's ``tail`` of Mamba2 layers) takes its indices as keys
(``tail.0.mamba.w_x``); an empty one carries no leaf, and the hybrid's
``tail`` comes back as ``[]``. xLSTM's stacked leaves keep their leading
(n_super, n_m) or (n_super,) axes (``super.m.mlstm.w_up``,
``super.s.slstm.r_gates``). numpy has no
bfloat16 of its own: ``params_from_jax`` takes JAX's bf16 arrays bit for
bit, and ``params_to_jax`` returns bf16 leaves as exact float32 arrays.

Optimizer state carries over for the LLM trees (``opt_state_from_jax`` /
``opt_state_to_jax``): AdamW's ``m`` and ``v`` are trees like the params,
its ``count`` an int array; SGD's ``momentum`` likewise. A leading worker
dimension on every leaf (``fl_step.init_worker_opt``) passes through.

The JAX CNN keeps its params as a nested dict of arrays in its own layout;
the port keeps a flat dict of PyTorch-layout tensors. Three differences:

  conv weights   HWIO (JAX)          ↔ OIHW (port)
  fc weights     (in, out)           ↔ (out, in)
  fc1 inputs     NHWC-flatten rows   ↔ NCHW-flatten columns: the JAX CNN
                 in (H, W, C) order     flattens its (B, 4, 4, 20) maps in
                                        HWC order, the port its (B, 20, 4, 4)
                                        maps in CHW order

Both directions take and give numpy-convertible arrays, never JAX objects:
``params_from_jax`` accepts the JAX tree after ``np.asarray`` on its leaves
(or the jax arrays themselves, which numpy converts), ``params_to_jax``
returns a nested dict of numpy arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _fc1_rows_to_cols(w: np.ndarray, channels: int) -> np.ndarray:
    """JAX fc1 (H·W·C, out) in HWC row order → port (out, C·H·W)."""
    hw = w.shape[0] // channels
    side = int(round(hw ** 0.5))
    w = w.reshape(side, side, channels, -1).transpose(2, 0, 1, 3)
    return w.reshape(channels * hw, -1).T


def _fc1_cols_to_rows(w: np.ndarray, channels: int) -> np.ndarray:
    """Port fc1 (out, C·H·W) → JAX (H·W·C, out) in HWC row order."""
    hw = w.shape[1] // channels
    side = int(round(hw ** 0.5))
    w = w.T.reshape(channels, side, side, -1).transpose(1, 2, 0, 3)
    return w.reshape(hw * channels, -1)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, order="C").view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _lists(node):
    """Nested dicts whose keys are 0..n-1 → lists, at every depth."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """JAX params → the port's flat dict on ``device``: an LLM tree
    (``"embed"`` in it) key for key, or the nested CNN params
    ({layer: {"w", "b"}}) with the layout changes above."""
    if "embed" in tree:
        return {k: _tensor(v, device) for k, v in sorted(_flatten(tree))}
    t = {layer: {k: np.asarray(v) for k, v in leaves.items()}
         for layer, leaves in tree.items()}
    c2 = t["conv2"]["w"].shape[-1]
    out = {
        "conv1.w": t["conv1"]["w"].transpose(3, 2, 0, 1),
        "conv2.w": t["conv2"]["w"].transpose(3, 2, 0, 1),
        "fc1.w": _fc1_rows_to_cols(t["fc1"]["w"], c2),
        "fc2.w": t["fc2"]["w"].T,
    }
    for layer in t:
        out[f"{layer}.b"] = t[layer]["b"]
    return {k: _tensor(v, device) for k, v in sorted(out.items())}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict:
    """The port's flat dict → nested numpy params in the JAX layout."""
    if "embed" in params:
        out: Dict = {}
        for k, v in params.items():
            *path, leaf = k.split(".")
            node = out
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = _array(v)
        out = _lists(out)
        if "shared" in out:                # the hybrid, its tail empty or not
            out.setdefault("tail", [])
        return out
    p = {k: v.detach().cpu().numpy() for k, v in params.items()}
    c2 = p["conv2.w"].shape[0]
    w = {
        "conv1": p["conv1.w"].transpose(2, 3, 1, 0),
        "conv2": p["conv2.w"].transpose(2, 3, 1, 0),
        "fc1": _fc1_cols_to_rows(p["fc1.w"], c2),
        "fc2": p["fc2.w"].T,
    }
    return {layer: {"b": p[f"{layer}.b"], "w": np.ascontiguousarray(w[layer])}
            for layer in sorted(w)}


def opt_state_from_jax(state, device="cpu") -> Dict:
    """An LLM's optimizer state (AdamW ``{m, v, count}`` or SGD
    ``{momentum}``, worker-stacked or not) → the port's layout: each tree a
    flat dict as ``params_from_jax`` makes it, ``count`` an int32 tensor."""
    out = {}
    for k, v in state.items():
        out[k] = (_tensor(np.asarray(v, np.int32), device) if k == "count"
                  else params_from_jax(v, device))
    return out


def opt_state_to_jax(state: Dict) -> Dict:
    """The inverse of ``opt_state_from_jax``, as nested numpy."""
    return {k: (state[k].detach().cpu().numpy() if k == "count"
                else params_to_jax(state[k])) for k in state}
