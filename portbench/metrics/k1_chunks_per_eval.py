"""k1_chunks_per_eval: K1's node chunks per eval at the cell's launch shape
(``chunks_per_eval`` of the program's ``k1_plan`` counter, noted at every
launch from the chunk the operator settled at its first call)."""

from portbench import k1plan


def read(run):
    e = k1plan.entry(run)
    return float(e["chunks_per_eval"]) if e else None
