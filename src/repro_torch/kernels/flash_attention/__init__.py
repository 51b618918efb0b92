"""Flash attention: the hand-written CUDA kernel (``kernel.py``,
``csrc/flash_attention.cu``), its plain PyTorch version (``ref.py``) and
the device dispatch (``ops.py``)."""
