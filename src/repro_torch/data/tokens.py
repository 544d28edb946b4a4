"""Deterministic synthetic LM token pipeline with per-node domain skew.

For large-model D-SGD training we emulate data heterogeneity as *domain skew*
over a synthetic corpus: the corpus has K domains, each with its own n-gram
token distribution; node i draws documents from its own domain mixture
``Pi[i]``. The per-node domain mixtures play exactly the role of the label
proportions in Proposition 2 (heterogeneity is a mixture over K conditional
distributions), so STL-FW consumes ``Pi`` unchanged.

Batches are generated on host from a counter-based seeded RNG: batch ``t`` of
node ``i`` is a pure function of ``(seed, i, t)`` -- no state to checkpoint,
reproducible across restarts/reshards, and shardable (each data-axis host
generates only its own rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DomainSkewCorpus", "TokenBatcher"]


@dataclasses.dataclass
class DomainSkewCorpus:
    """K domains, each a Markov-ish unigram distribution over the vocab.

    Domain k's token distribution is a Zipf re-ranked by a domain-specific
    permutation, so domains overlap but are statistically distinct.
    """

    vocab_size: int
    n_domains: int = 10
    zipf_a: float = 1.2
    seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        base = ranks ** (-self.zipf_a)
        base /= base.sum()
        self._probs = np.empty((self.n_domains, self.vocab_size))
        for k in range(self.n_domains):
            perm = rng.permutation(self.vocab_size)
            self._probs[k] = base[perm]

    def domain_probs(self, k: int) -> np.ndarray:
        return self._probs[k]

    def sample_tokens(
        self, domain: int, shape: tuple[int, ...], rng: np.random.Generator
    ) -> np.ndarray:
        # Gumbel-max sampling keeps memory bounded for large vocabs.
        flat = int(np.prod(shape))
        # chunk to avoid (flat, vocab) blowups
        out = np.empty(flat, dtype=np.int32)
        logp = np.log(self._probs[domain])
        chunk = max(1, min(flat, 1 << 14))
        for s in range(0, flat, chunk):
            e = min(flat, s + chunk)
            g = rng.gumbel(size=(e - s, self.vocab_size))
            out[s:e] = np.argmax(logp[None, :] + g, axis=1)
        return out.reshape(shape)


class TokenBatcher:
    """Counter-seeded per-node LM batches under a domain mixture ``Pi``.

    ``next_batch(step)`` returns ``(tokens, labels)`` of shape
    ``(n_nodes, per_node_batch, seq_len)`` -- labels are next-token shifted.
    """

    def __init__(
        self,
        corpus: DomainSkewCorpus,
        Pi: np.ndarray,
        per_node_batch: int,
        seq_len: int,
        seed: int = 0,
    ) -> None:
        self.corpus = corpus
        self.Pi = np.asarray(Pi, dtype=np.float64)
        self.n_nodes = self.Pi.shape[0]
        self.per_node_batch = per_node_batch
        self.seq_len = seq_len
        self.seed = seed
        if self.Pi.shape[1] != corpus.n_domains:
            raise ValueError("Pi columns must match corpus domains")

    def node_batch(self, node: int, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(node, step))
        )
        domains = rng.choice(
            self.corpus.n_domains, size=self.per_node_batch, p=self.Pi[node]
        )
        toks = np.empty((self.per_node_batch, self.seq_len + 1), dtype=np.int32)
        for b, dom in enumerate(domains):
            toks[b] = self.corpus.sample_tokens(int(dom), (self.seq_len + 1,), rng)
        return toks[:, :-1], toks[:, 1:]

    def next_batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for i in range(self.n_nodes):
            x, y = self.node_batch(i, step)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)
