"""Embedding retrieval serving: sharded store, CUDA top-k scans and the
micro-batching frontend (the port of the JAX package's ``embed_serve``)."""
from repro_torch.embed_serve.batcher import (BatcherStats,  # noqa: F401
                                             MicroBatcher, drive_open_loop)
from repro_torch.embed_serve.quant import (DEFAULT_OVERFETCH,  # noqa: F401
                                           dequantize_rows, overfetch_m,
                                           quantize_rows, rescore_exact,
                                           topk_mips_quant_rescored)
from repro_torch.embed_serve.store import (QUERY_IMPLS,  # noqa: F401
                                           ShardedEmbeddingStore, TopKMeta,
                                           recall_at_k)
from repro_torch.embed_serve.topk import (  # noqa: F401
    merge_topk, select_topk, topk_mips, topk_mips_plain, topk_mips_quant,
    topk_mips_quant_plain, topk_mips_rowwise, topk_mips_rowwise_plain)
