"""RG-LRU linear recurrence: the hand-written CUDA kernel (``kernel.py``,
``csrc/rglru_scan.cu``), its plain PyTorch version (``ref.py``) and the
device dispatch (``ops.py``)."""
