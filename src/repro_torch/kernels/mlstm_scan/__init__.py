"""Chunkwise mLSTM: the hand-written CUDA kernel (``kernel.py``,
``csrc/mlstm_scan.cu``), its plain PyTorch version (``ref.py``) and the
device dispatch (``ops.py``)."""
