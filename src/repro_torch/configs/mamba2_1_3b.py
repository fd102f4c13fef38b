"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]. d_inner = 2*d_model = 4096, 64 heads x 64 head_dim,
d_state=128. Decode state is O(1) in context length.

A copy of the JAX package's ``configs/mamba2_1_3b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                    # attention-free, no FFN (Mamba-2 block only)
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    train_microbatches=4,
)
