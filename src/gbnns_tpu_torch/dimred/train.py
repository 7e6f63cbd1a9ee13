"""Load side of the learned projection: checkpoints written by the JAX
package's ``dimred.train.save_projection`` (a flat npz of parameter leaves
keyed ``params/<layer>/<kernel|bias>`` plus a ``__cfg__`` repr), loaded
without unpickling code, and applied in full fp32. Training is still to be
ported (ROADMAP.md).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any

import numpy as np
import torch

from gbnns_tpu_torch._device import resolve_device
from gbnns_tpu_torch.dimred.models import make_model
from gbnns_tpu_torch.kernels.distance import exact_fp32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The trainer's settings, as stored in a checkpoint's ``__cfg__``. The
    load side reads ``model``, ``d_out``, ``hidden`` and ``metric``; the
    rest record how the projection was trained."""

    d_out: int
    model: str = "linear"          # "linear" | "mlp"
    hidden: int = 512              # mlp only
    metric: str = "l2"             # "l2" | "ip" | "angular"
    margin: float | None = None
    lr: float = 1e-3
    batch_size: int = 1024
    steps: int = 2000
    k_pos: int = 10
    hard_negatives: bool = True
    neg_ranks: tuple[int, int] | None = None
    init: str = "pca"
    eval_every: int = 0
    val_queries: int = 1024
    val_c: int = 16
    seed: int = 0

    @property
    def normalize(self) -> bool:
        return self.metric == "angular"


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX parameter leaves → this package's ``state_dict``: a (d_in, d_out)
    kernel becomes ``nn.Linear``'s (d_out, d_in) weight."""
    state = {}
    for key, value in flat.items():
        parts = key.split("/")
        if len(parts) != 3 or parts[0] != "params" \
                or parts[1] not in ("proj", "hidden") \
                or parts[2] not in ("kernel", "bias"):
            raise ValueError(f"unexpected projection leaf {key!r}")
        t = torch.from_numpy(np.array(value, np.float32))  # a writable copy
        state[f"{parts[1]}.{'weight' if parts[2] == 'kernel' else 'bias'}"] = (
            t.T.contiguous() if parts[2] == "kernel" else t)
    return state


def load_projection(path: str, *, device=None) -> dict[str, Any]:
    """``{"model": nn.Module on device (eval mode), "cfg": TrainConfig}``
    from a JAX projection checkpoint."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        cfg = TrainConfig(**ast.literal_eval(str(data["__cfg__"][0])))
        flat = {k: data[k] for k in data.files if k != "__cfg__"}
    first = "params/hidden/kernel" if cfg.model == "mlp" else "params/proj/kernel"
    d_in = flat[first].shape[0]
    model = make_model(cfg.model, d_in, cfg.d_out, hidden=cfg.hidden,
                       normalize=cfg.normalize)
    model.load_state_dict(params_from_jax(flat))
    return {"model": model.to(dev).eval(), "cfg": cfg}


def projector(trained: dict[str, Any]):
    """The projection as a callable on device tensors (full fp32, no
    autograd), for ``SearchService(projection=...)``."""
    model = trained["model"]

    def apply(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), exact_fp32():
            return model(x)

    return apply


@torch.no_grad()
def project(trained: dict[str, Any], x, *, chunk: int = 262144) -> np.ndarray:
    """Apply the projection to (m, d) rows, streamed in chunks on the
    model's device, in full fp32. Returns a numpy array like the JAX
    ``project``."""
    model = trained["model"]
    dev = next(model.parameters()).device
    x = np.asarray(x, np.float32)
    outs = []
    with exact_fp32():
        for off in range(0, len(x), chunk):
            xc = torch.from_numpy(np.ascontiguousarray(x[off:off + chunk]))
            outs.append(model(xc.to(dev)).cpu().numpy())
    return np.concatenate(outs, axis=0)
