"""Embedding retrieval serving: sharded store, CUDA top-k scans and the
micro-batching frontend (the port of the JAX package's ``embed_serve``)."""
from repro_torch.embed_serve.batcher import (BatcherStats,  # noqa: F401
                                             MicroBatcher, drive_open_loop)
from repro_torch.embed_serve.quant import (dequantize_rows,  # noqa: F401
                                           overfetch_m, quantize_rows,
                                           rescore_exact,
                                           topk_mips_quant_rescored)
from repro_torch.embed_serve.store import (ShardedEmbeddingStore,  # noqa: F401
                                           recall_at_k)
from repro_torch.embed_serve.topk import (merge_topk, select_topk,  # noqa: F401
                                          topk_mips, topk_mips_plain,
                                          topk_mips_quant,
                                          topk_mips_quant_plain)
