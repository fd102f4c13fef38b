"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].

The mel-spectrogram + conformer feature frontend is a STUB per the
assignment: `input_specs()` supplies precomputed frame embeddings (B, Se, d)
to the 24-layer encoder; the 24-layer decoder cross-attends. For train/
prefill shapes the seq budget is split S/2 frames + S/2 tokens; for decode
shapes the encoder memory is capped at `frontend_len_cap` frames.

A copy of the JAX package's ``configs/seamless_m4t_large_v2.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,             # decoder
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    modality="audio",
    frontend_len_cap=8192,
    train_microbatches=4,
)
