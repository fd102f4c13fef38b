"""granite-3-2b [dense] — GQA kv=8, tied embeddings
[hf:ibm-granite/granite-3.0-2b-base].

A copy of the JAX package's ``configs/granite_3_2b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=1e4,
    train_microbatches=4,
)
