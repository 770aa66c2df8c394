"""ANN indexing of binary (``bit``) vectors — hamming and jaccard.

The reference supports HNSW indexes over the ``bit`` type through the
``bit_hamming_ops`` / ``bit_jaccard_ops`` operator classes (upstream
``pgvector:src/bitvec.c`` distances + the generic HNSW AM in
``pgvector:src/hnsw.c``; its graph traversal calls ``hamming_distance``
per neighbor via the popcount loops of ``bitutils.c``).

Reformulation for the dense engines, which need no popcount:

- **Hamming** over bit vectors *is* squared L2 over their {0,1}
  encodings: ``|a - b|^2 = sum (a_i - b_i)^2 = sum (a_i XOR b_i)``.
  Encoding each bit as a 0/1 bf16 lane turns every graph/block engine's
  existing L2 machinery (matmul form, exact elementwise batched scores,
  k-means blocking) into an *exact* hamming engine — distances come back
  as exact small integers, no new kernel code. The memory trade is
  explicit: 2 bytes/bit versus 1/32 packed (the packed + XOR/popcount
  path remains the right call for exact flat scans and lives in
  :class:`~tpu_hnsw.ops.bitops.BinaryFlatIndex` and the Pallas kernel in
  ``ops/pallas_hamming.py``; this module is for when graph/blocked ANN
  over millions of binary vectors beats an exact scan).
- **Jaccard** (``1 - |a&b| / |a|b|``) has no monotone dense-metric
  equivalent, so it runs two-stage: candidate generation with the cosine
  engine over the same {0,1} encoding (cosine ``I/sqrt(|a||b|)`` tracks
  jaccard ``I/(|a|+|b|-I)`` closely — both are intersection counts
  normalized by set sizes), then an **exact** packed XOR/AND popcount
  rerank of the candidate pool. Results are exact jaccard distances;
  only the candidate pool is approximate, widened via ``rerank_k``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index.block import BlockHnswIndex
from tpu_hnsw.index.hnsw import HnswIndex
from tpu_hnsw.ops import bitops


def unpack_bits(packed: np.ndarray, nbits: int) -> np.ndarray:
    """[..., W] uint32 lanes -> [..., nbits] of {0,1} uint8 (inverse of
    :func:`tpu_hnsw.ops.bitops.pack_bits`)."""
    p = np.asarray(packed, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (p[..., :, None] >> shifts) & np.uint32(1)
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 32)[..., :nbits].astype(
        np.uint8
    )


class BinaryHnswIndex:
    """HNSW ANN over binary vectors (``bit_hamming_ops`` /
    ``bit_jaccard_ops`` parity; see module docstring for the design).

    Parameters mirror :class:`HnswConfig` where applicable; ``engine``
    selects the classical graph traversal (``"graph"``) or the blocked
    flagship (``"block"``). Inputs to :meth:`build`/:meth:`add`/
    :meth:`search` are raw bit arrays ``[N, nbits]`` of {0,1} (any int
    dtype / bool), or packed uint32 lanes with ``packed=True``.
    """

    def __init__(
        self,
        nbits: int,
        metric: str = "hamming",
        m: int = 16,
        ef_construction: int = 64,
        engine: str = "graph",
        block_size: int = 256,
        seed: int = 0,
        max_elements: int = 0,
    ):
        if metric not in ("hamming", "jaccard"):
            raise ValueError("metric must be hamming or jaccard")
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph or block")
        self.nbits = int(nbits)
        self.metric = metric
        self.engine = engine
        inner_metric = Metric.L2 if metric == "hamming" else Metric.COSINE
        self.cfg = HnswConfig(
            dim=self.nbits,
            metric=inner_metric,
            m=m,
            ef_construction=ef_construction,
            dtype="bfloat16",  # 0/1 is exact in bf16; halves HBM
            seed=seed,
            max_elements=max_elements,
        )
        if engine == "graph":
            self.inner = HnswIndex(self.cfg)
        else:
            self.inner = BlockHnswIndex(self.cfg, block_size=block_size)
        # packed copy in id order, kept only for the exact jaccard rerank
        self._packed: np.ndarray | None = None

    # -- encoding ---------------------------------------------------------

    def _bits(self, x, packed: bool) -> np.ndarray:
        if packed:
            return unpack_bits(x, self.nbits)
        b = np.asarray(x)
        if b.shape[-1] != self.nbits:
            raise ValueError(
                f"expected {self.nbits} bits, got {b.shape[-1]}"
            )
        return (b != 0).astype(np.uint8)

    def _encode(self, bits: np.ndarray) -> np.ndarray:
        return bits.astype(np.float32)

    def _store_packed(self, ids: np.ndarray, bits: np.ndarray) -> None:
        if self.metric != "jaccard":
            return
        rows = bitops.pack_bits(bits)
        hi = int(np.max(ids)) + 1
        if self._packed is None:
            self._packed = np.zeros((hi, rows.shape[-1]), np.uint32)
        elif self._packed.shape[0] < hi:
            grown = np.zeros((hi, self._packed.shape[1]), np.uint32)
            grown[: self._packed.shape[0]] = self._packed
            self._packed = grown
        self._packed[ids] = rows

    # -- index lifecycle --------------------------------------------------

    @property
    def n(self) -> int:
        return self.inner.n

    def build(self, data, packed: bool = False, **kw) -> "BinaryHnswIndex":
        bits = self._bits(data, packed)
        self.inner.build(self._encode(bits), **kw)
        self._store_packed(np.arange(bits.shape[0]), bits)
        return self

    def add(self, data, packed: bool = False) -> np.ndarray:
        bits = self._bits(data, packed)
        n0 = self.inner.n
        out = self.inner.add(self._encode(bits))
        ids = (
            np.asarray(out)
            if isinstance(out, np.ndarray)
            else np.arange(n0, n0 + bits.shape[0])
        )
        self._store_packed(ids, bits)
        return ids

    def delete(self, ids) -> None:
        self.inner.delete(ids)

    def save(self, path: str) -> None:
        """Persist (inner engine snapshot + binary meta + packed rerank
        rows); same explicit-snapshot durability model as the dense
        engines (SURVEY.md §5 checkpoint/resume)."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        self.inner.save(os.path.join(path, "inner"))
        meta = {
            "nbits": self.nbits,
            "metric": self.metric,
            "engine": self.engine,
            "block_size": getattr(self.inner, "block_size", 0),
        }
        with open(os.path.join(path, "binary_meta.json"), "w") as f:
            json.dump(meta, f)
        if self._packed is not None:
            np.savez(os.path.join(path, "packed.npz"), packed=self._packed)

    @classmethod
    def load(cls, path: str) -> "BinaryHnswIndex":
        import json
        import os

        with open(os.path.join(path, "binary_meta.json")) as f:
            meta = json.load(f)
        if meta["engine"] == "graph":
            inner = HnswIndex.load(os.path.join(path, "inner"))
        else:
            inner = BlockHnswIndex.load(os.path.join(path, "inner"))
        idx = cls.__new__(cls)
        idx.nbits = meta["nbits"]
        idx.metric = meta["metric"]
        idx.engine = meta["engine"]
        idx.cfg = inner.cfg
        idx.inner = inner
        pk = os.path.join(path, "packed.npz")
        idx._packed = np.load(pk)["packed"] if os.path.exists(pk) else None
        return idx

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["binary_nbits"] = self.nbits
        s["binary_encoding"] = "0/1 bf16 (2 bytes/bit; packed flat scan is"
        " 1/8 byte/bit — see module docstring for the trade)"
        return s

    # -- search -----------------------------------------------------------

    def search(
        self,
        queries,
        k: int = 10,
        packed: bool = False,
        rerank_k: int = 0,
        **kw,
    ):
        """Top-k by exact hamming / exact jaccard distance.

        ``kw`` passes engine knobs through (``ef_search`` for the graph
        engine, ``probes`` for the block engine). For jaccard,
        ``rerank_k`` (default ``max(4k, 50)``) is the cosine candidate
        pool that the exact popcount rerank re-orders.

        Returns ``(distances [Q, k], ids [Q, k])`` — integer hamming
        counts (float array) or jaccard in [0, 1]; missing ids are -1
        with +inf distance.
        """
        qbits = self._bits(np.atleast_2d(queries), packed)
        q = self._encode(qbits)
        if self.metric == "hamming":
            if self.engine == "graph":
                kw.setdefault("ef_search", max(40, k))
            d, ids = self.inner.search(q, k=k, **kw)
            # score_to_distance took sqrt of the squared-L2 (= hamming)
            ham = np.where(
                np.isfinite(d), np.rint(np.square(d)), np.inf
            )
            return ham, ids
        # jaccard: cosine candidates, exact packed rerank
        cand = int(rerank_k) if rerank_k else max(4 * k, 50)
        cand = min(cand, max(self.inner.n, k))
        if self.engine == "graph":
            cand = min(cand, 1000)  # ef_search GUC range (config.py)
            kw["ef_search"] = max(kw.get("ef_search", 40), cand)
        _, cids = self.inner.search(q, k=cand, **kw)
        qp = jnp.asarray(bitops.pack_bits(qbits), jnp.uint32)
        cp = jnp.asarray(self._packed, jnp.uint32)
        safe = jnp.asarray(np.maximum(cids, 0))
        rows = jnp.take(cp, safe, axis=0)  # [Q, C, W]
        inter = jnp.sum(
            bitops.popcount(jnp.bitwise_and(qp[:, None, :], rows)), axis=-1
        )
        union = jnp.sum(
            bitops.popcount(jnp.bitwise_or(qp[:, None, :], rows)), axis=-1
        )
        jd = 1.0 - inter / jnp.maximum(union, 1)
        jd = jnp.where(jnp.asarray(cids) < 0, jnp.inf, jd)
        vals, pos = jax.lax.top_k(-jd, k)
        ids = np.take_along_axis(cids, np.asarray(pos), axis=1)
        d = np.asarray(-vals)
        ids = np.where(np.isfinite(d), ids, -1)
        return d, ids
