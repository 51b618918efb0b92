"""The plain reference that decides ``correct``: float32 PyTorch with
TF32 off, written from the published models, importing nothing of the
program (``repro_torch``) and nothing of the JAX package."""
