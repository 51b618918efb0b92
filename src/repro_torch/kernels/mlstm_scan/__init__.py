"""Chunkwise mLSTM: the hand-written CUDA kernels (``kernel.py``,
``csrc/mlstm_scan.cu`` and ``csrc/mlstm_wgmma.cuh``) and its backward
(``backward.py``, ``csrc/mlstm_scan_bwd.cu`` and
``csrc/mlstm_bwd_wgmma.cuh``), their plain PyTorch versions and the
tensor-core kernels' arithmetic in plain PyTorch (``ref.py``), and the
device dispatch with the autograd Function (``ops.py``)."""
