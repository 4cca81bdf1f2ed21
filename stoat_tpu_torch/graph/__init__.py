"""Graph mode of the port (``stoat graph``): see graph/association.py."""

from stoat_tpu_torch.graph.association import run_graph_association

__all__ = ["run_graph_association"]
