"""RG-LRU linear recurrence: the hand-written CUDA kernel (``kernel.py``,
``csrc/rglru_scan.cu``) and its backward (``backward.py``, the same
source's reversed instance), their plain PyTorch versions (``ref.py``)
and the device dispatch with the autograd Function (``ops.py``)."""
