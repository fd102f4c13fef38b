"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437].

The assignment table lists d_ff=2048 — that is the per-expert hidden dim;
the first 3 layers are dense with d_ff=18432, per the paper. MLA dims are
the paper's: q_lora 1536, kv_lora 512, nope/rope head dims 128/64, v 128.
`long_500k` decode keeps FULL attention: the compressed MLA cache for 524k
tokens is only ~0.6 GB (the architecture's selling point).

A copy of the JAX package's ``configs/deepseek_v3_671b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                # dense layers (first 3)
    vocab_size=129280,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp=True,
    moe_num_experts=256,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_num_shared=1,
    moe_layer_start=3,
    moe_layer_period=1,
    optimizer="adafactor",
    train_microbatches=8,
    prefill_chunk=2048,
)
