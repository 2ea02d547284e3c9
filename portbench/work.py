"""The yardstick of the rooflines: the work the fast Fourier spectral method
needs for one collision eval, whatever implements it, and the card's peaks.

Per distribution per eval the method transforms, as complex 3-D transforms
of ``n = Nx Ny Nz`` points at ``5 n log2 n`` flops each:

* f once forward;
* each of the B quadrature nodes (after the antipodal reduction) twice
  inverse, its two phased streams;
* each of the G radial groups once forward, the group's summed product
  (beta1 depends on the radial node alone);
* the gain and the loss spectra once inverse each;

so ``(3 + 2B + G) 5 n log2 n`` flops.  The bytes are f read and Q written
once.  Elementwise work (phases, products, multipliers) is not counted: it
only lowers the count, so no eval of the method reads above 100%.
"""

from __future__ import annotations

import math

#: Dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
#: sheet): float64 on the tensor cores (DMMA); for float32 data the TF32
#: tensor-core rate, the highest at which float32 inputs multiply on the card.
PEAK_FLOPS = {"float64": 67e12, "float32": 495e12}
#: HBM3 bandwidth of the H100 SXM.
PEAK_BYTES_PER_S = 3.35e12
_ITEMSIZE = {"float64": 8, "float32": 4}


def quadrature_nodes(config: dict) -> tuple[int, int]:
    """(B, G): quadrature nodes after the antipodal reduction, and radial
    groups, of a configuration's numbers."""
    g = int(config.get("n_radial") or config["nv"])
    per_group = config["ns"] // 2 if config.get("antipodal", True) else config["ns"]
    return g * per_group, g


def grid_points(config: dict) -> int:
    return math.prod(config.get("shape") or (config["nv"],) * 3)


def eval_flops(config: dict, batch: int = 1) -> float:
    """Flops of one eval of ``batch`` distributions by the FFT method."""
    n = grid_points(config)
    b, g = quadrature_nodes(config)
    return batch * (3 + 2 * b + g) * 5.0 * n * math.log2(n)


def eval_bytes(config: dict, batch: int = 1) -> float:
    """Bytes of one eval: f in and Q out."""
    return 2.0 * batch * grid_points(config) * _ITEMSIZE[config["dtype"]]


def least_seconds(config: dict, batch: int = 1) -> float:
    """The least time of one eval on the card: the larger of its flops over
    the peak rate of its precision and its bytes over the bandwidth."""
    return max(eval_flops(config, batch) / PEAK_FLOPS[config["dtype"]],
               eval_bytes(config, batch) / PEAK_BYTES_PER_S)
