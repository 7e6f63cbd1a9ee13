from gbnns_tpu_torch.search.rerank import rerank
from gbnns_tpu_torch.search.flat import FlatIndex
from gbnns_tpu_torch.search.walker import SearchResult, beam_search
from gbnns_tpu_torch.search.graph_index import GraphIndex

__all__ = ["rerank", "FlatIndex", "SearchResult", "beam_search",
           "GraphIndex"]
