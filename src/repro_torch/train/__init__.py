"""Training-side modules: the checkpoint format, the LM serving steps and
the LM data stand-in."""
