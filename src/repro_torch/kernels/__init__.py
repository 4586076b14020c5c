"""Kernel layer of the port — the hot spots of the trust round and of the
danube and zamba2 serve paths on the H100.

``pack``
    A param dict as ONE contiguous (W, D) matrix: leaves in sorted-key
    order (the JAX package's leaf order), deltas stored in the param dtype.
``trust_score`` (K1), ``trust_agg`` (K2), ``fused_round`` (K3)
    Each holds a wrapper that launches a hand-written CUDA kernel
    (``repro_torch/csrc/*.cu``) for tensors on the card, the plain PyTorch
    version it runs for tensors on the CPU, a launch counter
    (``wrapper.launches``) and the kernel's HBM byte count.
``ssd_scan`` (K4)
    The SSD / decay-attention chunk scan of every Mamba2 layer's prefill
    (zamba2), with the same layout, plus the FLOP count, the card
    tolerance (``excess``) and the planted faults its checks must reject.
``swa_decode`` (K5)
    Sliding-window single-token decode attention of the danube serve path,
    with the same layout: wrapper, plain version, counter, byte count.
``ref``
    The plain versions gathered under the reference's module name.
``_build``
    Builds the CUDA sources with ``nvcc`` at first use and calls them
    through ``ctypes``.

Every Pallas kernel of the reference (K1–K5) has its CUDA counterpart here.
"""
