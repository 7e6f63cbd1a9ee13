"""Triplet-loss trainer for the learned projection, and its checkpoints.

Port of ``gbnns_tpu/dimred/train.py``. Training samples (anchor, positive =
one of the anchor's ``k_pos`` true near neighbours, negative = a uniform
corpus row or a GT column in ``neg_ranks``) and minimizes the hinge
``max(0, m + d(f(a), f(p)) - d(f(a), f(n)))``, plus the same hinge against
each anchor's hardest in-batch negative, with Adam (optax's defaults, the
same update ``lr * m_hat / (sqrt(v_hat) + eps)``). Products run in full
fp32 (TF32 off). With ``eval_every`` the trainer scores the held-out
preservation of true neighbours every ``eval_every`` steps and returns the
best checkpoint seen, the step-0 init included.

Draws come from one ``torch.Generator`` seeded with ``seed + 1`` on the
training device, through ``draw_batch``; the JAX package draws with
``jax.random``, so the two trainers see other batches from one seed, and a
test replays JAX's draws by replacing ``draw_batch``.

Checkpoints keep the JAX package's layout: a flat npz of parameter leaves
keyed ``params/<layer>/<kernel|bias>`` (a kernel is (d_in, d_out), the
transpose of ``nn.Linear``'s weight) plus a ``__cfg__`` repr, loaded
without unpickling code. Each package loads the other's files.
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
    """The trainer's settings, stored in a checkpoint's ``__cfg__``.

    ``margin`` None resolves per metric: 1.0 for (squared) l2, 0.05 for ip
    and angular. ``neg_ranks=(lo, hi)`` draws each anchor's negative from
    its own GT ranks [lo, hi) instead of the corpus. ``init``: "pca" or
    "orthogonal" (linear model only). ``eval_every`` > 0 turns on the
    validation-gated selection over ``val_queries`` held-out rows, scored
    by the fraction of their true top-10 kept in their projected top
    ``val_c``; 0 returns the final step."""

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


def _pair_dist(a, b, metric: str):
    if metric in ("ip", "angular"):
        return -(a * b).sum(-1)
    diff = a - b
    return (diff * diff).sum(-1)


def draw_batch(gen: torch.Generator, n: int, cfg: TrainConfig):
    """One step's draws on ``gen``'s device: anchor rows, positive columns
    in [0, k_pos), and negatives: GT columns in ``neg_ranks``, or corpus
    rows when it is None. Each (batch_size,) int64."""
    b, dev = cfg.batch_size, gen.device
    a_idx = torch.randint(0, n, (b,), generator=gen, device=dev)
    p_col = torch.randint(0, cfg.k_pos, (b,), generator=gen, device=dev)
    lo, hi = cfg.neg_ranks if cfg.neg_ranks is not None else (0, n)
    neg = torch.randint(lo, hi, (b,), generator=gen, device=dev)
    return a_idx, p_col, neg


def _init_model(cfg: TrainConfig, base: np.ndarray, dev) -> torch.nn.Module:
    """The model at step 0: a linear model from PCA or a random orthonormal
    basis, an MLP from PyTorch's initializers; random draws from
    ``cfg.seed`` on the CPU's generator, restored after."""
    from gbnns_tpu_torch.dimred.pca import pca_fit

    d = base.shape[1]
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(cfg.seed)
        model = make_model(cfg.model, d, cfg.d_out, hidden=cfg.hidden,
                           normalize=cfg.normalize)
        if cfg.model == "linear":
            if cfg.init == "pca":
                # start from the classical optimum; the hinge improves on it
                w = torch.from_numpy(pca_fit(base, cfg.d_out,
                                             device=dev).components)
            else:
                m = max(d, cfg.d_out)
                w = torch.linalg.qr(torch.randn(m, m))[0][:d, :cfg.d_out]
            with torch.no_grad():
                model.proj.weight.copy_(w.T)
    return model.to(dev)


def train_projection(base, neighbors, cfg: TrainConfig, *,
                     log_every: int = 0, device=None) -> dict[str, Any]:
    """Train f: R^d -> R^d_out so neighbour order survives the projection.

    ``base``: (n, d) corpus; ``neighbors``: (n, >= k_pos) int rows of each
    row's true near neighbours (GT or a kNN graph). Returns ``{"model"
    (eval mode, on the device), "cfg", "losses" (steps,)}``, and with
    ``eval_every`` also ``"val_history"`` (step 0 first), ``"best_step"``
    and ``"best_val"``.
    """
    dev = resolve_device(device)
    need_cols = cfg.k_pos
    if cfg.neg_ranks is not None:
        lo, hi = cfg.neg_ranks
        if not (cfg.k_pos <= lo < hi):
            raise ValueError(f"neg_ranks must satisfy k_pos <= lo < hi, got "
                             f"{cfg.neg_ranks} with k_pos={cfg.k_pos}")
        need_cols = max(need_cols, hi)
    if neighbors.shape[1] < need_cols:
        raise ValueError(f"neighbors has {neighbors.shape[1]} columns but "
                         f"{need_cols} are needed (k_pos={cfg.k_pos}, "
                         f"neg_ranks={cfg.neg_ranks}); widen the GT rows")
    base = np.ascontiguousarray(base, np.float32)
    model = _init_model(cfg, base, dev)
    base = torch.from_numpy(base).to(dev)
    nbrs = torch.from_numpy(np.ascontiguousarray(
        np.asarray(neighbors)[:, :need_cols], np.int64)).to(dev)
    n = base.shape[0]
    margin = cfg.margin if cfg.margin is not None else (
        1.0 if cfg.metric == "l2" else 0.05)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)

    def step() -> torch.Tensor:
        a_idx, p_col, neg = draw_batch(gen, n, cfg)
        p_idx = nbrs[a_idx, p_col]
        n_idx = nbrs[a_idx, neg] if cfg.neg_ranks is not None else neg
        fa, fp, fn = model(base[a_idx]), model(base[p_idx]), model(base[n_idx])
        d_ap = _pair_dist(fa, fp, cfg.metric)
        loss = torch.relu(margin + d_ap - _pair_dist(fa, fn, cfg.metric))
        if cfg.hard_negatives:
            # each anchor's most violating other negative: one (B, B) product
            if cfg.metric in ("ip", "angular"):
                dmat = -(fa @ fn.T)
            else:
                dmat = ((fa * fa).sum(-1)[:, None] - 2.0 * (fa @ fn.T)
                        + (fn * fn).sum(-1)[None, :])
            # not a negative: the anchor itself or its positive
            same = ((n_idx[None, :] == a_idx[:, None])
                    | (n_idx[None, :] == p_idx[:, None]))
            d_hard = dmat.masked_fill(same, float("inf")).amin(dim=1)
            loss = loss + torch.relu(margin + d_ap - d_hard)
        loss = loss.mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    def run(n_steps: int) -> np.ndarray:
        with exact_fp32():
            out = [step() for _ in range(n_steps)]
        return torch.stack(out).cpu().numpy() if out else np.zeros(0,
                                                                   np.float32)

    if not cfg.eval_every:
        losses = run(cfg.steps)
        if log_every:
            for i in range(0, cfg.steps, log_every):
                print(f"  step {i}: loss {losses[i]:.4f}", flush=True)
        return {"model": model.eval(), "cfg": cfg, "losses": losses}

    # ---- validation-gated checkpoint selection (see TrainConfig) -------
    vgen = torch.Generator(device=dev)
    vgen.manual_seed(cfg.seed + 7)
    vq = torch.randperm(n, generator=vgen, device=dev)[:min(cfg.val_queries,
                                                           n)]
    val_gt = nbrs[vq, :min(10, nbrs.shape[1])]

    @torch.no_grad()
    def val_score() -> float:
        """Mean fraction of the true top-10 kept in the projected top
        val_c over the whole training corpus (self excluded)."""
        with exact_fp32():
            lo = model(base)
            qlo = lo[vq]
            if cfg.metric in ("ip", "angular"):
                scores = qlo @ lo.T
            else:
                scores = 2.0 * (qlo @ lo.T) - (lo * lo).sum(-1)[None, :]
        # the query is a corpus row and would always rank first
        scores[torch.arange(vq.shape[0], device=dev), vq] = -float("inf")
        top = torch.topk(scores, cfg.val_c, dim=1).indices
        hits = (top[:, None, :] == val_gt[:, :, None]).any(-1)
        return float(hits.float().mean())

    def snapshot() -> dict:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best = (val_score(), snapshot(), 0)
    history = [best[0]]
    parts = []
    done = 0
    while done < cfg.steps:
        seg = min(cfg.eval_every, cfg.steps - done)
        parts.append(run(seg))
        done += seg
        score = val_score()
        history.append(score)
        if score > best[0]:
            best = (score, snapshot(), done)
        if log_every:
            print(f"  step {done}: loss {parts[-1][-1]:.4f} "
                  f"val@{cfg.val_c} {score:.4f}", flush=True)
    model.load_state_dict(best[1])
    losses = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return {"model": model.eval(), "cfg": cfg, "losses": losses,
            "val_history": np.asarray(history), "best_step": best[2],
            "best_val": best[0]}


def params_to_jax(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """This package's ``state_dict`` -> JAX parameter leaves (the inverse
    of ``params_from_jax``)."""
    flat = {}
    for key, value in model.state_dict().items():
        layer, kind = key.split(".")
        v = value.detach().float().cpu().numpy()
        if kind == "weight":
            flat[f"params/{layer}/kernel"] = np.ascontiguousarray(v.T)
        else:
            flat[f"params/{layer}/bias"] = v
    return flat


def save_projection(path: str, trained: dict[str, Any]) -> None:
    """Write the JAX package's checkpoint layout: parameter leaves and the
    ``__cfg__`` repr of the config."""
    cfg = trained["cfg"]
    np.savez(path, __cfg__=np.array([repr(dataclasses.asdict(cfg))]),
             **params_to_jax(trained["model"]))
