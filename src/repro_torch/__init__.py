"""SAFA (semi-asynchronous federated learning) in PyTorch, with the
server-side kernels hand-written in CUDA for Hopper.

A port of the JAX package ``repro``, module for module: ``repro_torch.api``
is the entry point (``Experiment(...).compile().run()``).  Entry points run
on the card (``device='cuda'``) unless the caller passes ``device='cpu'``.
"""
