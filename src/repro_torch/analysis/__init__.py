"""Analysis of a step (port of ``analysis/``): the useful FLOPs of a cell
(``flops.py``), the work of a trace or of XLA's optimized HLO
(``hlo_parse.py``), and the roofline terms at an H100's peaks with the
LM kernels' work counts (``roofline.py``)."""
