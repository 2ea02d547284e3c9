"""The JAX package's seven examples (``examples/*.py``), on the port.

Each module has a ``main(argv=None)`` that returns what the JAX example's
``main`` returns, prints the same lines, and takes ``--device`` (default
``cuda``, which raises without a card; ``--device cpu`` runs the plain
versions)::

    python -m boltzfft_torch.examples.ozaki_contraction
    python -m boltzfft_torch.examples.bkw_relaxation --Nv 32 --Ns 12 --steps 12
    python -m boltzfft_torch.examples.convergence_study --max-nv 64
    python -m boltzfft_torch.examples.precision_ladder --Nv 32
    python -m boltzfft_torch.examples.adjoint_fit --impl fused
    python -m boltzfft_torch.examples.mixing_2d3v [--shard]
    python -m boltzfft_torch.examples.taylor_green_2d3v [--local]
    torchrun --nproc-per-node 4 -m boltzfft_torch.examples.mixing_2d3v --shard
"""
