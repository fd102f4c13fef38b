"""PyTorch and CUDA port of the node-embedding system, beside the JAX
package ``repro``.

Two paths are ported. Training (``launch/train.py``): graph → walks →
sample store → episode blocks → single-card hybrid trainer, whose inner
loop is one hand-written CUDA kernel per minibatch (the fused SGNS update)
→ link-prediction AUC → checkpoint. Retrieval serving
(``launch/embed_serve.py``): that checkpoint loads into a sharded store, a
micro-batcher coalesces requests, and hand-written CUDA kernels scan the
shards. Importing the package builds nothing; each kernel is compiled at
its first launch (``repro_torch.kernels.build``). The package imports torch
and numpy only, never JAX or the JAX package.
"""
