"""PyTorch/CUDA port of the query-focused accelerated-HITS serving stack.

Laid out module for module like the JAX package ``repro`` (the
reference): ``graph`` and ``core`` hold the host-side graph work and the
paper's sweeps, ``sparse`` the deterministic segmented SpMV, ``kernels``
the hand-written CUDA kernels for the H100 with their plain-torch
versions, and ``serve`` the batched, cached ranking service. It imports
torch, numpy and the standard library only. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
