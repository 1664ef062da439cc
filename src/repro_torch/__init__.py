"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

Imports torch and numpy only: never JAX and nothing of the JAX package
``repro``, which stays the reference the port is held against.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Subpackages mirror the reference: ``configs``, ``core`` (the TL protocol
simulator), ``data``, ``kernels`` (hand-written sm_90a kernels with their
plain versions), ``models``, ``optim``, ``serve``, ``launch``; ``bridge``
converts reference parameters and optimizer states into the port's.
"""
