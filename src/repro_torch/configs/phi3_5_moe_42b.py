"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]. Every layer is MoE (expert ff 6400).

A copy of the JAX package's ``configs/phi3_5_moe_42b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=6400,
    moe_layer_start=0,
    moe_layer_period=1,
    optimizer="adafactor",
    train_microbatches=4,
    prefill_chunk=2048,
)
