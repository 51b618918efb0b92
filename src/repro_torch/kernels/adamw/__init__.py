"""AdamW's two passes on the card: the hand-written CUDA kernels
(``kernel.py``, ``csrc/adamw.cu``).  Their plain PyTorch versions are
``optim/adamw.py``'s ``global_norm_plain`` and ``_update_slice``, which
``adamw_update`` takes for CPU and ``meta`` tensors."""
