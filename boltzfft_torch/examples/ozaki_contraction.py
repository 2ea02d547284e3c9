"""The Ozaki-scheme sliced contraction, standalone.

Demonstrates the core trick behind ``boltzfft_torch.oz`` (the engine that
runs the ds collision pipeline's transforms on the card's bf16 tensor cores,
K7-K10): a double-single value splits into 7-bit mantissa chunks that are
exactly representable in bfloat16; chunk-pair dot products accumulate
*exactly* in a 24-bit float32 accumulator (7 + 7 + log2(K) <= 24 bits for
K <= 1024); and the handful of slice-pair results recombine with
compensated adds.  The matmul runs at bf16 tensor-core rates while the
result carries ~49 mantissa bits.  The contraction here is the staged
plain-PyTorch engine (``oz.contract_last_oz``), the kernels' reference.

    python -m boltzfft_torch.examples.ozaki_contraction [--device cpu]
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    from boltzfft_torch import ds, oz
    from boltzfft_torch.cli import open_device

    device = open_device(args.device)
    rng = np.random.default_rng(7)
    rows, k, ell = 256, 64, 64
    # wide per-row dynamic range — the regime where naive f32 loses digits
    x64 = (
        rng.standard_normal((rows, k)) * 10.0 ** rng.uniform(-6, 4, (rows, 1))
        + 1j * rng.standard_normal((rows, k)) * 10.0 ** rng.uniform(-6, 4, (rows, 1))
    )
    m64 = np.exp(1j * rng.uniform(0, 2 * np.pi, (k, ell))) / k
    ref = x64 @ m64
    scale = np.max(np.abs(ref))

    # plain f32: ~2^-24
    f32 = (x64.astype(np.complex64) @ m64.astype(np.complex64)).astype(complex)
    print(f"plain f32 matmul    rel err: {np.max(np.abs(f32 - ref))/scale:.3e}")

    # the sliced ds contraction: bf16-exact chunks, exact f32 accumulation,
    # compensated recombination -> ~2^-49
    x = ds.cds_from_f64(x64, device=device)
    msl = oz.slice_matrix(m64, device=device)
    out = oz.contract_last_oz(x, msl)
    got = ds.to_f64(out.re) + 1j * ds.to_f64(out.im)
    print(f"Ozaki ds contraction rel err: {np.max(np.abs(got - ref))/scale:.3e}")

    # show the decomposition on one value: chunks sum back to the ds pair
    sl = oz.slice_ds_last(x.re)
    rec = np.sum(sl.float().cpu().numpy().astype(np.float64), axis=0)
    err = np.max(np.abs(rec - ds.to_f64(x.re))
                 / np.max(np.abs(x64.real), axis=-1, keepdims=True))
    print(f"chunk reconstruction (row-relative): {err:.3e}")
    print(f"chunks per value: {sl.shape[0]} x 7 bits, stored bf16")


if __name__ == "__main__":
    sys.exit(main())
