"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every 2nd
layer, 16 experts top-2 [arXiv:2403.19887].

Only 4 of 32 layers are attention, so long-context decode keeps full
attention caches.

A copy of the JAX package's ``configs/jamba_v0_1_52b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # Jamba period-8 block: attention at slot 4, Mamba elsewhere (1:7)
    layer_pattern="MMMMAMMM",
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    # MoE every 2nd layer, 16 experts top-2, expert ff = d_ff
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_layer_start=1,
    moe_layer_period=2,
    optimizer="adafactor",
    train_microbatches=4,
    prefill_chunk=2048,
)
