"""Synthetic data, the port's own numpy copy.

Ports ``BigramLM``, ``lm_batches`` and ``SyntheticCIFAR`` of
``repro/data/synthetic.py`` line for line, so one seed gives the same
tokens and images in both packages: language-model token streams with a
planted bigram structure, and CIFAR-like images from per-class gaussian
prototypes (the paper's CIFAR-10 stand-in; nothing is downloaded).
"""
from __future__ import annotations

import numpy as np


class BigramLM:
    """Markov-chain token source: each class of batch follows a sparse
    bigram table, giving a learnable next-token distribution."""

    def __init__(self, vocab, seed=0, branching=4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.next_tokens = rng.integers(0, vocab, size=(vocab, branching))
        self.probs = rng.dirichlet(np.ones(branching), size=vocab)

    def sample(self, rng, batch, seq):
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(1, seq):
            prev = toks[:, t - 1]
            choice = np.array([rng.choice(self.next_tokens.shape[1],
                                          p=self.probs[p]) for p in prev])
            toks[:, t] = self.next_tokens[prev, choice]
        return toks


def lm_batches(vocab, batch_shape, seq, seed=0, codebooks=0, vision=None):
    """Infinite iterator of ``{"tokens": int32 array}`` batches shaped
    ``batch_shape + (seq,)``; ``batch_shape`` is ``(K, C, mb)`` for a
    federated round.  ``codebooks``: that many token streams stacked on a
    trailing axis (``batch_shape + (seq, codebooks)``); ``vision = (P,
    vision_d)``: a ``patches`` leaf of standard normals ``batch_shape +
    (P, vision_d)`` float32 beside the tokens."""
    src = BigramLM(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    flat = int(np.prod(batch_shape))
    while True:
        if codebooks:
            toks = np.stack([src.sample(rng, flat, seq)
                             for _ in range(codebooks)], axis=-1)
            toks = toks.reshape(tuple(batch_shape) + (seq, codebooks))
        else:
            toks = src.sample(rng, flat, seq).reshape(
                tuple(batch_shape) + (seq,))
        batch = {"tokens": toks}
        if vision is not None:
            P, vd = vision
            batch["patches"] = rng.standard_normal(
                tuple(batch_shape) + (P, vd)).astype(np.float32)
        yield batch


class SyntheticCIFAR:
    """Gaussian class prototypes + noise; image_size x image_size x 3."""

    def __init__(self, n_classes=10, image_size=32, n_train=50_000,
                 n_test=10_000, noise=0.6, seed=0):
        rng = np.random.default_rng(seed)
        self.protos = rng.standard_normal(
            (n_classes, image_size, image_size, 3)).astype(np.float32)
        self.n_classes = n_classes
        self.image_size = image_size
        self.noise = noise
        self.train = self._make(rng, n_train)
        self.test = self._make(rng, n_test)

    def _make(self, rng, n):
        labels = rng.integers(0, self.n_classes, size=n)
        imgs = (self.protos[labels]
                + self.noise * rng.standard_normal(
                    (n, self.image_size, self.image_size, 3))
                ).astype(np.float32)
        return {"images": imgs, "labels": labels.astype(np.int32)}
