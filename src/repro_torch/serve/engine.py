"""LM serving engine: batched decode with slot-based continuous batching.
A copy of ``repro.serve.engine``'s ``Request`` and ``DecodeServer``.

One fixed-size batch of decode slots; a finished sequence frees its slot
and a queued request joins at the next step.  Each admission is
prefilled on its own (``transformer.prefill``) and spliced into its slot
of the server's fp32 cache; then one ``transformer.decode_step`` runs over
every slot, idle ones included, each at its own position.  Decoding is
greedy: the first maximum over the padded vocabulary.  Everything runs on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0


class DecodeServer:
    """``model`` is a :class:`repro_torch.models.transformer.LM` on
    ``device``.  The cache holds ``slots`` sequences of ``max_len``
    positions in fp32, as the reference's does."""

    def __init__(self, cfg: LMConfig, model: T.LM, *, slots: int = 8,
                 max_len: int = 256, greedy: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.cache = T.init_cache(cfg, slots, max_len, torch.float32,
                                  device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._next_rid = 0

        self._decode = functools.partial(T.decode_step, cfg)
        self._prefill = functools.partial(T.prefill, cfg)

    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens,
                                  t_submit=time.perf_counter()))
        return rid

    # -- internals ----------------------------------------------------------

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                plen = len(req.prompt)
                if plen > self.max_len:
                    raise ValueError(
                        f"request {req.rid}: a prompt of {plen} tokens does "
                        f"not fit a cache of {self.max_len} positions")
                # prefill this prompt on its own, then splice into slot s
                toks = torch.tensor([req.prompt], dtype=torch.int32,
                                    device=self.device)
                logits, cache = self._prefill(self.model, toks)
                kv = self.cache["kv"]
                kv[:, s].zero_()
                kv[:, s, :plen] = cache["kv"][:, 0].to(kv.dtype)
                self.slot_pos[s] = plen
                req.out_tokens.append(int(torch.argmax(logits[0])))
                self.slot_req[s] = req

    def step(self) -> int:
        """One decode step over all active slots; returns #active."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        tok = np.zeros(self.slots, np.int32)
        for s in active:
            tok[s] = self.slot_req[s].out_tokens[-1]
        # each slot writes and attends at its own position
        self.cache["length"] = torch.tensor(self.slot_pos, device=self.device)
        logits, self.cache = self._decode(
            self.model, self.cache, torch.tensor(tok, device=self.device))
        nxt = torch.argmax(logits, dim=-1).tolist()
        for s in active:
            req = self.slot_req[s]
            self.slot_pos[s] += 1
            req.out_tokens.append(nxt[s])
            if (len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                self.slot_req[s] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        for _ in range(max_steps):
            if not any(self.slot_req) and not self.queue:
                break
            self.step()
        return self.finished
