"""PyTorch/CUDA port of the FastCHGNet reproduction.

A second package beside ``repro`` (the JAX reference, which it never
imports).  It mirrors ``repro``'s layout: ``core`` (model), ``batching``
(host-side packing), ``kernels`` (hand-written CUDA kernels and their
plain PyTorch versions), ``serve`` (batched MD serving), ``convert`` (the
weight bridge from the JAX parameter tree).
"""
