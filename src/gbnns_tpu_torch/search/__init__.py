from gbnns_tpu_torch.search.rerank import rerank
from gbnns_tpu_torch.search.flat import FlatIndex

__all__ = ["rerank", "FlatIndex"]
