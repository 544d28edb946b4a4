"""The LM cell's token batches, made from the seed on the device.

A frozen copy of the port's domain-skew corpus (``repro_torch/data/
tokens.py``: each domain a Zipf unigram over the vocabulary, re-ranked by a
permutation of its own) and of ``chip_smoke.py``'s ``card_batches``: each
sequence takes a domain from its node's row of Pi and draws its tokens
i.i.d. from that domain, as the first entry of the domain's float64 CDF
above a uniform draw (``torch.multinomial`` sums its CDF on the card in an
order that varies from run to run). Labels are the next tokens.
"""

from __future__ import annotations

import numpy as np
import torch


def domain_probs(vocab: int, n_domains: int, zipf_a: float, seed: int) -> np.ndarray:
    """(n_domains, vocab): a Zipf(``zipf_a``) unigram, re-ranked by a
    permutation a domain."""
    rng = np.random.default_rng(seed)
    base = np.arange(1, vocab + 1, dtype=np.float64) ** (-zipf_a)
    base /= base.sum()
    return np.stack([base[rng.permutation(vocab)] for _ in range(n_domains)])


def batches(probs: np.ndarray, Pi: np.ndarray, steps: int, batch: int, seq: int,
            device: torch.device, seed: int) -> dict[str, torch.Tensor]:
    """``{"tokens", "labels"}``, each (steps, n, batch, seq) int64."""
    n_domains, vocab = probs.shape
    n = Pi.shape[0]
    rng = np.random.default_rng(seed)
    doms = np.stack([np.stack([rng.choice(n_domains, size=batch, p=Pi[i]) for i in range(n)])
                     for _ in range(steps)])
    cdf = torch.as_tensor(np.cumsum(probs, axis=1), dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((steps, n, batch, seq + 1), generator=gen, dtype=torch.float64, device=device)
    toks = torch.empty(u.shape, dtype=torch.int64, device=device)
    dom = torch.as_tensor(doms, device=device)
    for d in range(n_domains):
        sel = dom == d
        if bool(sel.any()):
            toks[sel] = torch.searchsorted(cdf[d], u[sel] * cdf[d, -1], right=True
                                           ).clamp_(max=vocab - 1)
    return {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
