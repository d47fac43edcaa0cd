"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy, written from the paper (FedDCT, arXiv
2307.04420, Algs. 2-4 and Eqs. 2-7) and the benchmark's own inputs: it
imports nothing of the program under test, of the JAX package or of
JAX.  ``model`` is the paper's CNN and ResNet8 over a cohort of clients
(grouped convolutions, no im2col, no kernels) with Adam; ``schedule``
replays the FedDCT schedulers (sync and semi-async) from the traffic's
delays and the accuracies a run reports; ``merge`` is the server's
weighted average and the sequential staleness merge, in float64.
"""
