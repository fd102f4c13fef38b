"""The paper's embedding configuration (a copy of the JAX package's
``configs/tencent_embedding.py``)."""
