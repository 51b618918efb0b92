"""Chunkwise mLSTM: the hand-written CUDA kernels (``kernel.py``,
``csrc/mlstm_scan.cu`` and ``csrc/mlstm_wgmma.cuh``), its plain PyTorch
version and the tensor-core kernel's arithmetic in plain PyTorch
(``ref.py``), and the device dispatch (``ops.py``)."""
