"""GEPS grid-brick event processing on PyTorch and CUDA.

The PyTorch port of the ``repro`` package: the same modules at the same
relative paths, with brick data held as device-resident torch tensors,
the fused ``event_filter`` scan and the dense LM's attention written as
hand-made CUDA kernels for Hopper (``kernels/*/csrc/*.cu``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
