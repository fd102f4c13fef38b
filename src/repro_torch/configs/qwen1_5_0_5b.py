"""qwen1.5-0.5b [dense] — MHA, QKV bias [hf:Qwen/Qwen1.5-0.5B].

A copy of the JAX package's ``configs/qwen1_5_0_5b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    train_microbatches=4,
)
