"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The ViT/SigLIP vision tower and projector are stubs: the batch supplies
precomputed patch embeddings (anyres: base 576 patches + 576 per tile;
1152 = base + one tile) already projected to d_model, and the language
transformer consumes them as a prefix.

A copy of the JAX package's ``configs/llava_next_mistral_7b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    modality="vision",
    frontend_len_cap=1152,     # anyres patches supplied by the stub frontend
    train_microbatches=4,
)
