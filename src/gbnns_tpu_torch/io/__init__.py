from gbnns_tpu_torch.io.vecs import read_vecs, write_vecs, read_fvecs, read_ivecs, read_bvecs, write_fvecs, write_ivecs
from gbnns_tpu_torch.io.synthetic import make_synthetic, SyntheticSpec
from gbnns_tpu_torch.io.datasets import DATASETS, load_dataset, Dataset

__all__ = [
    "read_vecs", "write_vecs", "read_fvecs", "read_ivecs", "read_bvecs",
    "write_fvecs", "write_ivecs",
    "make_synthetic", "SyntheticSpec",
    "DATASETS", "load_dataset", "Dataset",
]
