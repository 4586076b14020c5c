"""Checkpointing: msgpack+zstd snapshots with chain-recorded hashes (the
twin of ``repro.checkpoint.store``).

A checkpoint is the IPFS blob format (content-addressed) written to disk;
``save`` optionally records the cid on the ledger so restarts are auditable
(the paper's §III.D traceability property, extended to training state).

Trees are the port's (nested) dicts of tensors or numpy arrays, flattened
in sorted-key order (``chain.ipfs.flatten_tree``). The blob holds
``{"step", "tree"}``, so leaf 0 is the step. bf16 leaves are stored as f32
data (numpy has no bf16) and come back bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.chain.ipfs import _pack_tree, _unpack_leaves, flatten_tree
from repro_torch.chain.ledger import Ledger, sha256


def save(path: str, tree: Any, *, step: int = 0,
         ledger: Optional[Ledger] = None) -> str:
    blob = _pack_tree({"step": np.int64(step), "tree": tree})
    cid = sha256(blob)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)                      # atomic publish
    if ledger is not None:
        ledger.append_block([{"type": "checkpoint", "step": step, "cid": cid}])
    return cid


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure and dtypes of ``like``: tensor leaves
    come back on ``like``'s device, numpy leaves as numpy arrays."""
    with open(path, "rb") as f:
        blob = f.read()
    leaves, _ = _unpack_leaves(blob)
    step = int(np.asarray(leaves[0]))
    rest = leaves[1:]
    n_like = len(flatten_tree(like))
    if len(rest) != n_like:
        raise ValueError(f"checkpoint has {len(rest)} leaves, expected "
                         f"{n_like}")
    return _fill(like, iter(rest)), step


def _fill(like: Any, leaves: Iterator[np.ndarray]) -> Any:
    """``like``'s tree with its leaves taken in sorted-key order."""
    if isinstance(like, dict):
        return {k: _fill(like[k], leaves) for k in sorted(like)}
    r = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(r).reshape(like.shape)).to(
            device=like.device, dtype=like.dtype)
    like = np.asarray(like)
    return np.asarray(r).astype(like.dtype).reshape(like.shape)


def verify(path: str, cid: str) -> bool:
    with open(path, "rb") as f:
        return sha256(f.read()) == cid
