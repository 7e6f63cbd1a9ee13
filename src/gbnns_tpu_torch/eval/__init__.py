from gbnns_tpu_torch.eval.recall import recall_at_k, exact_ground_truth
from gbnns_tpu_torch.eval.bench import time_search, sweep

__all__ = ["recall_at_k", "exact_ground_truth", "time_search", "sweep"]
