"""SDFL-B in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s layout module for module
(``repro_torch/core/fl_step.py`` is the twin of ``repro/core/fl_step.py``)
and imports nothing from it. JAX-free host modules (configs, data, chain,
reputation, async simulator) are verbatim copies with the package name
changed; the device side is PyTorch, and the three trust kernels of the
fused round, the sliding-window decode attention of the danube serve path
and the SSD chunk scan of the zamba2 serve path are hand-written CUDA under
``csrc/`` (see ``kernels``).

Entry points (``core.protocol.SDFLBProtocol``, ``core.node.ChainNode``,
``core.fl_step.make_fl_round``, ``launch.serve.serve``) run on ``cuda``
unless the caller passes ``device="cpu"``; see ``device.resolve_device``.
"""
