"""Data pipelines of the port: the LM trainer's token stream."""
