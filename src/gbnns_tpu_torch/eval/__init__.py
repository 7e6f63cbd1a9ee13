from gbnns_tpu_torch.eval.recall import recall_at_k, exact_ground_truth

__all__ = ["recall_at_k", "exact_ground_truth"]
