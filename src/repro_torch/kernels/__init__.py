"""Kernel layer of the port — the hot spots of the trust round and of the
danube serve path on the H100.

``pack``
    A param dict as ONE contiguous (W, D) matrix: leaves in sorted-key
    order (the JAX package's leaf order), deltas stored in the param dtype.
``trust_score`` (K1), ``trust_agg`` (K2), ``fused_round`` (K3)
    Each holds a wrapper that launches a hand-written CUDA kernel
    (``repro_torch/csrc/*.cu``) for tensors on the card, the plain PyTorch
    version it runs for tensors on the CPU, a launch counter
    (``wrapper.launches``) and the kernel's HBM byte count.
``swa_decode`` (K5)
    Sliding-window single-token decode attention of the danube serve path,
    with the same layout: wrapper, plain version, counter, byte count.
``ref``
    The plain versions gathered under the reference's module name.
``_build``
    Builds the CUDA sources with ``nvcc`` at first use and calls them
    through ``ctypes``.

The Pallas kernel ``ssd_scan`` (Mamba2/mLSTM prefill) is not ported yet
(see ROADMAP.md).
"""
