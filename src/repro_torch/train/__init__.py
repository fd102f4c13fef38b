"""Training-side modules the serving slice needs (the checkpoint format)."""
