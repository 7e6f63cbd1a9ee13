from gbnns_tpu_torch.build.kmeans import kmeans_assign, kmeans_fit
from gbnns_tpu_torch.build.knn_graph import (
    add_reverse_edges, build_knn_graph, connected_components,
    ensure_connected, forward_reachable, load_graph, save_graph,
)

__all__ = ["add_reverse_edges", "build_knn_graph", "connected_components",
           "ensure_connected", "forward_reachable", "save_graph",
           "load_graph", "kmeans_fit", "kmeans_assign"]
