"""Continuous-batching serving engine (counterpart of
``repro/serving/engine.py``).

A fixed pool of ``max_slots`` decode slots shares one batched cache.
Requests join as slots free up: each is prefilled alone and its per-layer
state written into its slot; every :meth:`step` decodes one token for all
slots at their own positions (a ``[max_slots]`` ``pos`` vector in
``decode_step``).  A finished request (EOS or its length budget) frees its
slot at once, so a long generation never holds up the queue.

Everything lives on one device, the parameters'.  The prefill sets the
kernels' switches, as ``launch/serve.py`` does: on the card the attention
layers' prefill runs the flash-attention kernel and the recurrent layers'
scan the RG-LRU kernel; on the CPU both take their plain versions.  A step
reads the host once, its ``[max_slots]`` greedy tokens; an admission once,
the request's first token.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core.tree_util import tree_leaves
from repro_torch.models.registry import Model


@dataclass
class _Request:
    rid: int
    prompt: torch.Tensor           # [S] int64 on the engine's device
    max_new: int
    eos: Optional[int]
    out: List[int] = field(default_factory=list)


class ServeEngine:
    def __init__(self, model: Model, params, *, max_slots: int,
                 cache_len: int, eos: Optional[int] = None):
        if model.cfg.family == "audio":
            raise ValueError("encoder-only model cannot be served for decode")
        self.model = model
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.eos = eos
        self.caches = model.init_cache(max_slots, cache_len, self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int64,
                               device=self.device)              # next position
        self.tok = torch.zeros((max_slots, 1), dtype=torch.int64,
                               device=self.device)              # next input
        self.active: Dict[int, _Request] = {}                   # slot -> request
        self._next_rid = 0
        self.waiting: List[_Request] = []

    def _prefill(self, batch):
        return self.model.prefill(self.params, batch,
                                  cache_len=self.cache_len, use_flash=True,
                                  use_lru_kernel=True)

    def _insert(self, single, slot: int) -> None:
        """Write a single-request cache (batch dim 1) into ``slot`` of the
        pool, in place."""
        for c, s in zip(tree_leaves(self.caches), tree_leaves(single)):
            if c.dim() >= 2:
                c[:, slot] = s[:, 0]

    def _step(self, tok, pos):
        return self.model.decode_step(self.params, self.caches, tok, pos)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int, eos: Optional[int] = None) -> int:
        """Queue a request; returns its id."""
        rid = self._next_rid
        self._next_rid += 1
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int64)
        self.waiting.append(_Request(rid, prompt, max_new,
                                     eos if eos is not None else self.eos))
        self._admit()
        return rid

    def _free_slots(self):
        return [s for s in range(self.max_slots) if s not in self.active]

    def _admit(self) -> None:
        with torch.no_grad():
            for slot in self._free_slots():
                if not self.waiting:
                    break
                req = self.waiting.pop(0)
                last, single = self._prefill({"tokens": req.prompt[None, :]})
                self._insert(single, slot)
                first = torch.argmax(last[0])
                req.out.append(int(first))
                self.pos[slot] = req.prompt.shape[0]
                self.tok[slot, 0] = first
                self.active[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> List[_Request]:
        """Decode one token for every active slot; returns the finished
        requests (their slots are refilled from the queue at once)."""
        if not self.active:
            self._admit()
            if not self.active:
                return []
        with torch.no_grad():
            logits, self.caches = self._step(self.tok, self.pos)
            nxt = torch.argmax(logits, dim=-1)
        self.pos = self.pos + 1                     # inactive slots harmless
        self.tok = nxt[:, None]
        host = nxt.tolist()                         # the step's one host read
        done = []
        for slot, req in list(self.active.items()):
            t = host[slot]
            req.out.append(t)
            finished = (len(req.out) >= req.max_new
                        or (req.eos is not None and t == req.eos))
            if finished:
                done.append(req)
                del self.active[slot]
        if done:
            self._admit()
        return done

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drain the queue; returns {request id: generated tokens}."""
        results = {}
        for _ in range(max_steps):
            for req in self.step():
                results[req.rid] = req.out
            if not self.active and not self.waiting:
                break
        return results
