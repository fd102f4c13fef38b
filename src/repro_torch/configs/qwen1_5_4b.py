"""qwen1.5-4b [dense] — MHA (kv=heads), QKV bias [hf:Qwen/Qwen1.5-0.5B].

A copy of the JAX package's ``configs/qwen1_5_4b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    train_microbatches=2,
    prefill_chunk=4096,
)
