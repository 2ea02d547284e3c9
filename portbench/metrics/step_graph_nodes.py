"""step_graph_nodes: the nodes of the step unit's last captured CUDA graph
(``cudaGraphGetNodes`` on the capture's graph, counted by
``boltzfft_torch.obs`` at every capture)."""

from portbench import spans


def read(run):
    return spans.step_counter(run, "graph_nodes")
