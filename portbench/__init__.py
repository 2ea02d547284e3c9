"""The benchmark of ``boltzfft_torch``, the PyTorch and CUDA port: a
harness driven by the data files beside it (``run.py`` runs one cell)."""
