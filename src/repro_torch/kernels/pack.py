"""Flat-pack layer: a param dict as ONE contiguous (W, D) matrix.

The fused trust path streams the cohort's whole update volume through the
trust kernels, which want a single dense matrix, not a dict of per-layer
stacks.

  ``PackSpec``       static slice metadata: leaf names in pack order,
                     per-leaf shape/size/offset, pack dtype, total width D.
                     Rows are ``[leaf0.ravel() | leaf1.ravel() | ...]`` with
                     leaves in sorted-key order — the JAX package's
                     ``jax.tree.leaves`` order for the same nested names
                     (``conv1.b, conv1.w, conv2.b, …, fc2.w``).
  ``pack_delta``     per-worker deltas (new − global) straight into the
                     (W, D) matrix: subtract in f32, store in the pack dtype.
  ``pack_stack``     (W, ...)-leaf dict → (W, D)   (async pending).
  ``unpack_vector``  (D,) → param-shaped dict (views into the vector).
  ``unpack_stack``   (W, D) → (W, ...)-leaf dict.

Dtype policy: the pack dtype is the dict's common leaf dtype (bf16 deltas
keep full relative precision); a dict mixing dtypes is not ``packable``
and keeps the per-leaf path.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class PackSpec(NamedTuple):
    """Static slice metadata of a flat-packed param dict."""
    keys: Tuple[str, ...]                 # leaf names, pack order (sorted)
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf shapes (no W dim)
    sizes: Tuple[int, ...]                # per-leaf element counts
    offsets: Tuple[int, ...]              # per-leaf start column in the pack
    dtype: torch.dtype                    # common storage dtype of the pack
    total: int                            # D: columns of the packed matrix

    def slices(self):
        """(key, offset, size, shape) per leaf, in pack order."""
        return tuple(zip(self.keys, self.offsets, self.sizes, self.shapes))


def packable(params: Params) -> bool:
    """True iff every leaf shares one floating dtype."""
    if not params:
        return False
    dts = {x.dtype for x in params.values()}
    return len(dts) == 1 and next(iter(dts)).is_floating_point


def pack_spec(params: Params) -> PackSpec:
    """Layout from a template param dict (no leading W dims)."""
    if not params:
        raise ValueError("cannot pack an empty param dict")
    keys = tuple(sorted(params))
    shapes = tuple(tuple(params[k].shape) for k in keys)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    dtype = functools.reduce(torch.promote_types,
                             (params[k].dtype for k in keys))
    return PackSpec(keys, shapes, sizes, tuple(offsets), dtype, off)


def pack_delta(new_params_w: Params, global_params: Params,
               spec: PackSpec) -> torch.Tensor:
    """Per-worker deltas into the (W, D) pack:
    ``(new_f32 − global_f32).to(pack_dtype)``, the per-leaf path's rule."""
    W = new_params_w[spec.keys[0]].shape[0]
    return torch.cat(
        [(new_params_w[k].float() - global_params[k].float()[None])
         .to(spec.dtype).reshape(W, -1) for k in spec.keys], dim=1)


def pack_stack(tree_w: Params, spec: PackSpec, dtype=None) -> torch.Tensor:
    """(W, ...)-leaf dict → (W, D) in ``dtype`` (default: pack dtype)."""
    W = tree_w[spec.keys[0]].shape[0]
    dt = spec.dtype if dtype is None else dtype
    return torch.cat([tree_w[k].reshape(W, -1).to(dt) for k in spec.keys],
                     dim=1)


def unpack_vector(vec: torch.Tensor, spec: PackSpec) -> Params:
    """(D,) → param-shaped dict, keeping the vector's dtype."""
    return {k: vec[o:o + s].reshape(shape)
            for k, o, s, shape in spec.slices()}


def unpack_stack(mat: torch.Tensor, spec: PackSpec) -> Params:
    """(W, D) → (W, ...)-leaf dict, keeping the matrix's dtype."""
    W = mat.shape[0]
    return {k: mat[:, o:o + s].reshape((W,) + shape)
            for k, o, s, shape in spec.slices()}
