"""Device choice and the numerics settings of the port's CUDA path."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one (the tests pass ``"cpu"``). Without a CUDA device and
    without an explicit request this raises: the port never carries on
    silently on the CPU. While a ``FakeTensorMode`` is active (the dry run,
    ``repro_torch.launch.dryrun``, traces ``cuda`` steps on fake tensors,
    which allocate nothing) it returns ``cuda`` without a card; outside
    one, on a host with no card, it still raises.

    On a CUDA device it also fixes the numerics of the round (process-wide
    PyTorch switches): TF32 off for cuDNN convolutions and cuBLAS matmuls
    (cuDNN defaults to TF32, which keeps ~3 decimal digits), and
    deterministic cuDNN algorithms with autotuning off, so two same-seed
    runs produce bit-identical scores, params and therefore block hashes.
    bf16 matmuls accumulate in full f32 (cuBLAS may otherwise reduce in
    bf16), as the reference's bf16 products do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() and not fake_mode_active():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev


def fake_mode_active() -> bool:
    """Whether a ``torch._subclasses.FakeTensorMode`` is active."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None
