from gbnns_tpu_torch.kernels.distance import pairwise_dists, squared_norms
from gbnns_tpu_torch.kernels.topk import knn, knn_chunked

__all__ = ["pairwise_dists", "squared_norms", "knn", "knn_chunked"]
