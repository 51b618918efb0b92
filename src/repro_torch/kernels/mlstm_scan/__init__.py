"""Chunkwise mLSTM: the hand-written CUDA kernels (``kernel.py``,
``csrc/mlstm_scan.cu`` and ``csrc/mlstm_wgmma.cuh``) and its backward
(``backward.py``, ``csrc/mlstm_scan_bwd.cu``), their plain PyTorch
versions and the tensor-core kernel's arithmetic in plain PyTorch
(``ref.py``), and the device dispatch with the autograd Function
(``ops.py``)."""
