"""Continuous-batching serving engine: a slot pool, vLLM-style scheduling
on top of the model's prefill and decode steps.

Ports ``Request``, ``EngineStats`` and ``ContinuousBatcher`` of
``repro/launch/batching.py``.  A fixed pool of B slots shares one KV cache
laid out on a *global timeline* of ``max_len`` positions: a cohort of
requests admitted at time t stores its prompt at positions ``[t, t +
width)`` of the cache, and every decode tick appends one position.  RoPE
positions stay *logical* (0-based per request): the cohort's prefill runs
at ``pos_offset=0`` and each decode step takes its slots' own
``rope_pos``.  A ``[B, max_len]`` validity mask, passed to
``Model.decode_step``, keeps attention exact per slot: a slot sees its own
prompt and generated tokens only, never a retired request's or another
cohort's rows.

Scheduling is continuous: a slot retires on EOS or ``max_new`` and is
refilled from the queue at the next tick; when the timeline cannot hold a
cohort's prompts, the cohort goes back to the head of the queue.  Decode
runs eagerly, one ``decode_step`` a tick, where the reference jits one
program for all ticks.  The cohort's prefill builds caches of its prompt
width only (the reference pads them to ``max_len`` and then takes the
same ``[0, width)``), which spares a second full-length cache on the card.

Attention families only (dense, MoE, MLA, whose compressed ``c`` and
``kr`` caches merge as GQA's ``k`` and ``v`` do): recurrent SSM state
cannot be right-pad-masked without per-slot state swaps, so the SSM and
hybrid families are refused; serve them with generation-level batching
(``launch/serve.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [len] int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    completed: int = 0
    tokens_generated: int = 0


class ContinuousBatcher:
    """``model``'s serving over ``batch_slots`` slots and a timeline of
    ``max_len`` positions; ``params`` lie on the device it runs on."""

    def __init__(self, model, params, batch_slots=4, max_len=512,
                 eos_token: Optional[int] = None):
        cfg = model.cfg
        # the reference asserts both conditions; an explicit raise keeps
        # them under ``python -O``
        if cfg.family in ("ssm", "hybrid"):
            raise AssertionError(
                "recurrent state needs generation-level batching")
        if cfg.sliding_window and max_len > cfg.sliding_window:
            raise AssertionError(
                f"max_len {max_len} exceeds the sliding window "
                f"{cfg.sliding_window}: the timeline must fit the cache")
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos = eos_token
        self.stats = EngineStats()
        emb = params["embed"]
        self.device = emb.device
        self._cache = model.init_cache(batch_slots, max_len, emb.dtype,
                                       device=self.device)
        self._valid = np.zeros((batch_slots, max_len), bool)
        self._slot_req: List[Optional[Request]] = [None] * batch_slots
        self._pos = 0
        self._queue: List[Request] = []
        self._vocab = cfg.vocab

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request):
        self._queue.append(req)

    def _admit(self):
        empty = [i for i, r in enumerate(self._slot_req) if r is None]
        if not empty or not self._queue:
            return
        cohort = []
        while empty and self._queue:
            cohort.append((empty.pop(0), self._queue.pop(0)))
        width = max(len(r.prompt) for _, r in cohort)
        if self._pos + width + 2 >= self.max_len:
            self._queue = [r for _, r in cohort] + self._queue
            return
        toks = np.zeros((self.B, width), np.int64)
        for slot, req in cohort:
            toks[slot, :len(req.prompt)] = req.prompt      # right-pad
        with torch.no_grad():
            logits, cache = self.model.prefill(
                self.params, torch.as_tensor(toks, device=self.device),
                pos_offset=0, return_all_logits=True)
        slots = [s for s, _ in cohort]
        self._merge_cache(cache, width, slots)
        last = torch.tensor([len(r.prompt) - 1 for _, r in cohort],
                            device=self.device)
        first = torch.argmax(logits[torch.tensor(slots, device=self.device),
                                    last], -1).tolist()
        for (slot, req), tok in zip(cohort, first):
            plen = len(req.prompt)
            self._valid[slot, self._pos:self._pos + plen] = True
            self._slot_req[slot] = req
            req.out.append(int(tok) % self._vocab)
        self._pos += width
        self.stats.prefills += 1

    def _merge_cache(self, fresh, width, cohort_slots):
        """The cohort's rows of the fresh ``[B, width, ...]`` caches, placed
        at ``[pos, pos + width)`` of the timeline (dim 1 of each layer's
        ``k`` and ``v``, or MLA's ``c`` and ``kr``); the other slots' rows
        stay as they were."""
        sel = torch.tensor(cohort_slots, device=self.device)
        for path, new in fresh.items():
            if path.rsplit("/", 1)[-1] in ("k", "v", "c", "kr"):
                old = self._cache[path]
                old[sel, self._pos:self._pos + width] = \
                    new[sel, :width].to(old.dtype)

    # -- decode ---------------------------------------------------------------
    def step(self):
        self._admit()
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return False
        if self._pos + 1 >= self.max_len:
            return False                                    # timeline full
        tok = np.zeros((self.B,), np.int64)
        rope_pos = np.zeros((self.B,), np.int64)
        for i in active:
            req = self._slot_req[i]
            tok[i] = req.out[-1]
            rope_pos[i] = len(req.prompt) + len(req.out) - 1  # logical pos
        self._valid[active, self._pos] = True               # current token
        with torch.no_grad():
            logits, self._cache = self.model.decode_step(
                self.params, torch.as_tensor(tok, device=self.device),
                self._cache, self._pos,
                valid=torch.as_tensor(self._valid, device=self.device),
                rope_pos=torch.as_tensor(rope_pos, device=self.device))
        self._pos += 1
        self.stats.decode_steps += 1
        nxt = torch.argmax(logits, -1).tolist()
        for i in active:
            req = self._slot_req[i]
            t = int(nxt[i]) % self._vocab
            req.out.append(t)
            self.stats.tokens_generated += 1
            if (self.eos is not None and t == self.eos) \
                    or len(req.out) >= req.max_new + 1:
                req.done = True
                self.stats.completed += 1
                self._slot_req[i] = None
                self._valid[i, :] = False
        return True

    def run(self, max_ticks=100_000):
        """Tick until the queue and the slots are empty (or the timeline is
        full, or ``max_ticks``); returns the host seconds it took."""
        t0 = time.time()
        while (self._queue or any(r is not None for r in self._slot_req)) \
                and max_ticks > 0:
            progressed = self.step()
            if not progressed:
                break
            max_ticks -= 1
        return time.time() - t0
