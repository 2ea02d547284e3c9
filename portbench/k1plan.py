"""What the K1 metrics read: the always-on ``k1_plan`` counter of
``boltzfft_torch.obs`` (through :func:`portbench.spans.summary`) at the
cell's launch shape, ``"<E>x<Nx>x<Ny>x<Nz>"``, E the distributions one
rank's eval takes (``run.batch``)."""

from portbench import spans
from portbench.reference import spectral


def entry(run):
    """The cell's ``k1_plan`` entry (a dict), or None where the program noted
    none: another route, a CPU run (the plain version), a program without
    obs."""
    s = spans.summary(run)
    if s is None:
        return None
    key = "x".join(str(n) for n in (run.batch,) + spectral.grid(run.config, "cpu").shape)
    return s["counters"].get("k1_plan", {}).get(key)
