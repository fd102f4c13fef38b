"""PyTorch and CUDA port of the node-embedding system, beside the JAX
package ``repro``.

This slice serves embedding retrieval: a trainer checkpoint loads into a
sharded store, a micro-batcher coalesces requests, and hand-written CUDA
kernels (``kernels/csrc``) scan the shards. Importing the package builds
nothing; each kernel is compiled at its first launch
(``repro_torch.kernels.build``). The package imports torch and numpy only,
never JAX or the JAX package.
"""
