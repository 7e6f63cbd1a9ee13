"""Resident device-memory sizing of the search engines: the pre-check that
fails fast before an index that cannot fit is built.

Port of ``gbnns_tpu/search/sizing.py``, with the payload row alignment of
the port's packer (``walker_payload.pack_hop_payload``): a row is padded to
``ROW_WORDS`` = 32 f32 words (128 B, one full line of the card's memory
transactions), where the TPU package pads to its 4 KB (8, 128) tile. Every
formula matches the allocating code byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

ROW_WORDS = 32   # payload rows are whole 128-byte lines


def payload_row_words(K: int, d_lo: int, *, vec_dtype: str = "bfloat16",
                      row_words: int = ROW_WORDS) -> tuple[int, int]:
    """``(vec_words, words)`` of one packed hop-payload row: the f32 words
    holding its K x d_lo neighbour vectors (bf16 pairs or f32), and the row
    with its K int32 ids, padded to a multiple of ``row_words``."""
    if vec_dtype == "bfloat16":
        if (K * d_lo) % 2:
            raise ValueError(f"bf16 payload needs K*d_lo even "
                             f"(got K={K}, d_lo={d_lo})")
        vec_words = (K * d_lo) // 2
    elif vec_dtype == "float32":
        vec_words = K * d_lo
    else:
        raise ValueError(f"vec_dtype must be float32|bfloat16, "
                         f"got {vec_dtype!r}")
    return vec_words, -(-(vec_words + K) // row_words) * row_words


def payload_row_bytes(K: int, d_lo: int, *, vec_dtype: str = "bfloat16",
                      row_words: int = ROW_WORDS) -> int:
    """Bytes of one packed hop-payload row."""
    return 4 * payload_row_words(K, d_lo, vec_dtype=vec_dtype,
                                 row_words=row_words)[1]


@dataclass(frozen=True)
class HbmBreakdown:
    """Resident bytes of one engine configuration on one card."""

    engine: str
    n: int                    # corpus rows
    payload_bytes: int        # 0 for scan engines
    reduced_bytes: int        # search-space corpus
    rerank_bytes: int         # full-dimension re-rank corpus
    graph_bytes: int          # (n, K) int32 adjacency (0 if unused)
    norms_bytes: int          # per-row squared norms (f32)

    @property
    def total_bytes(self) -> int:
        return (self.payload_bytes + self.reduced_bytes + self.rerank_bytes
                + self.graph_bytes + self.norms_bytes)

    def fits(self, hbm_bytes: float, *, headroom: float = 2e9) -> bool:
        """Whether the resident bytes leave ``headroom`` of ``hbm_bytes``
        for scan scratch, temporaries and the query batch."""
        return self.total_bytes <= hbm_bytes - headroom

    def as_dict(self) -> dict:
        """The breakdown with its total, under the JAX package's keys
        (``fits_v5e_16gb`` and ``fits_v4_32gb`` answer for 16 and 32 GB of
        device memory, whatever the card)."""
        d = {f: int(getattr(self, f)) for f in
             ("payload_bytes", "reduced_bytes", "rerank_bytes",
              "graph_bytes", "norms_bytes")}
        d.update(engine=self.engine, n=self.n,
                 total_bytes=int(self.total_bytes),
                 total_gb=round(self.total_bytes / 1e9, 2),
                 fits_v5e_16gb=self.fits(16e9),
                 fits_v4_32gb=self.fits(32e9))
        return d


def graph_index_hbm(n: int, d: int, d_lo: int, K: int, *,
                    vec_dtype: str = "bfloat16", rerank_itemsize: int = 4,
                    row_words: int = ROW_WORDS) -> HbmBreakdown:
    """Resident bytes of a ``GraphIndex`` (payload walker + re-rank), as
    ``GraphIndex.build`` allocates them: the packed payload, the f32 reduced
    corpus (entry seeding), the re-rank corpus at ``rerank_itemsize`` and
    f32 norms. ``row_words=1024`` gives the JAX package's figure."""
    return HbmBreakdown(
        engine="graph_pallas", n=n,
        payload_bytes=n * payload_row_bytes(K, d_lo, vec_dtype=vec_dtype,
                                            row_words=row_words),
        reduced_bytes=n * d_lo * 4,
        rerank_bytes=n * d * rerank_itemsize,
        graph_bytes=0,   # the adjacency lives inside the payload rows
        norms_bytes=n * 4)


def fused_index_hbm(n: int, d: int, d_lo: int, *, scan_itemsize: int = 2,
                    rerank_itemsize: int = 4) -> HbmBreakdown:
    """Resident bytes of a ``FusedScanIndex``: scan corpus at
    ``scan_itemsize`` (2 bf16, 1 int8, 4 f32) and width ``d_lo``, re-rank
    corpus, norms. The scan's scores never reach device memory."""
    return HbmBreakdown(
        engine="fused", n=n, payload_bytes=0,
        reduced_bytes=n * d_lo * scan_itemsize,
        rerank_bytes=n * d * rerank_itemsize,
        graph_bytes=0, norms_bytes=n * 4)


def sharded_per_chip_hbm(n: int, n_chips: int, d: int, d_lo: int, K: int, *,
                         engine: str = "graph_pallas",
                         vec_dtype: str = "bfloat16",
                         rerank_itemsize: int = 4,
                         row_words: int = ROW_WORDS) -> HbmBreakdown:
    """Resident bytes on each device when the corpus shards n/P per device
    (``search.sharded``: contiguous shards, queries replicated, the (B, k)
    id/distance pairs the only cross-shard traffic, which is negligible
    next to the corpora). ``row_words=1024`` gives the JAX package's
    figure."""
    n_shard = -(-n // n_chips)
    if engine == "fused":
        b = fused_index_hbm(n_shard, d, d_lo,
                            rerank_itemsize=rerank_itemsize)
        # a sharded index keeps base_lo f32 and casts it at search time
        return HbmBreakdown(**{**b.__dict__, "reduced_bytes": n_shard * d_lo * 4,
                               "engine": "sharded_fused"})
    if engine == "graph_pallas":
        g = graph_index_hbm(n_shard, d, d_lo, K, vec_dtype=vec_dtype,
                            rerank_itemsize=rerank_itemsize,
                            row_words=row_words)
        # a sharded index also keeps the (n_shard, K) int32 local graph
        return HbmBreakdown(**{**g.__dict__, "graph_bytes": n_shard * K * 4,
                               "engine": "sharded_graph_pallas"})
    raise ValueError(f"unknown engine {engine!r}")
