"""GEPS grid-brick event processing on PyTorch and CUDA.

The PyTorch port of the ``repro`` package: the same modules at the same
relative paths, with brick data held as device-resident torch tensors
and the fused ``event_filter`` scan written as a hand-made CUDA kernel
for Hopper (``kernels/event_filter/csrc/event_filter.cu``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
