"""exp, log, sqrt and tanh whose CPU results do not depend on MKL's state.

On the CPU, PyTorch computes ``exp``, ``log`` and ``sqrt`` of float32
tensors (and ``exp`` of float64 ones) with MKL's vector math library
(VML), one call per OpenMP thread's slice of a tensor of more than 2048
elements. In a fresh process the threads' first calls can race in MKL's
lazy set-up: one thread's slice of the first ``torch.exp`` then comes back
from VML's AVX2 kernel in its low-accuracy mode (enhanced performance, ~11
bits; up to 1.5e-4 relative on exp of [-7, 0]) instead of the full-accuracy
kernel, and later calls are right (ROADMAP.md, fault F2).

The functions below compute in float64 through ``exp2``, ``log2`` and
``sqrt``, which PyTorch evaluates with its own vectorised code (SLEEF) in
any thread, and round once to the input's dtype: the same bits on a first
call as on any other, whatever MKL does. On the card they are the plain
``torch`` functions, which never enter MKL."""
from __future__ import annotations

import math

import torch

LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)


def exp(x: torch.Tensor) -> torch.Tensor:
    """e ** x in x's dtype (-inf gives 0)."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double() * LOG2E).to(x.dtype)


def exp_(x: torch.Tensor) -> torch.Tensor:
    """``exp`` in place; returns x."""
    if x.device.type != "cpu":
        return x.exp_()
    return x.copy_(torch.exp2(x.double() * LOG2E))


def log(x: torch.Tensor) -> torch.Tensor:
    """The natural logarithm in x's dtype."""
    if x.device.type != "cpu":
        return torch.log(x)
    return (torch.log2(x.double()) * LN2).to(x.dtype)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root in x's dtype, rounded once from float64 (so
    correctly rounded for float32)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh in x's dtype, computed in float64 on the CPU (whose tanh does
    not enter MKL, where float32's does) and rounded once."""
    if x.device.type != "cpu":
        return torch.tanh(x)
    return torch.tanh(x.double()).to(x.dtype)
