"""k1_stream_gib: GiB of K1's two node-stream buffers at the cell's launch
shape (``stream_bytes`` of the program's ``k1_plan`` counter: 2 buffers x 2
streams x E x the chunk's nodes x the grid's points x 16 or 8 bytes);
nothing where the program notes no such field."""

from portbench import k1plan


def read(run):
    e = k1plan.entry(run)
    return e["stream_bytes"] / 2**30 if e and "stream_bytes" in e else None
