"""Serving engine: continuous batching over a paged KV cache, with the
Bourbon SessionStore as the request-id -> page-table index.

The port of ``repro.serving.engine``, step for step:
  * fixed-size KV pages in a page pool (allocator = free list);
  * admission: new requests prefill and are registered in the SessionStore;
  * each engine step decodes one token for every active sequence,
    evicting finished ones and admitting queued ones (continuous batching);
  * batched SessionStore lookups route every step through the learned index
    (the paper's lookup path in the serving hot loop).

The model, its caches and the session store's engine run on ``device``
(the card unless ``device="cpu"``).  Decoding is ``decode_step`` under
``torch.inference_mode()``, eagerly; token batches go up pinned and
non-blocking, and the one host read a step makes is the argmax's
``.cpu()``, as the reference reads its argmax back.

As in the reference, prefill runs one whole-batch decode step per prompt
token, and the caches keep one position per layer shared by every slot:
every slot's cache advances on every slot's prefill and decode, and past
``max_seq`` steps each write lands in the last slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import resolve_device, upload
from repro_torch.models import decode_step, init_caches
from repro_torch.models.config import ModelConfig

from .session_store import PageRecord, SessionStore

__all__ = ["EngineConfig", "Request", "PagePool", "ServingEngine"]


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    page_tokens: int = 16
    n_pages: int = 4096
    eos_token: int = -1          # -1: run to max_new


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class PagePool:
    def __init__(self, n_pages: int) -> None:
        self.free = list(range(n_pages))

    def alloc(self, n: int) -> list[int]:
        if len(self.free) < n:
            raise MemoryError("page pool exhausted")
        pages, self.free = self.free[:n], self.free[n:]
        return pages

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 session_policy: str = "always",
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.pool = PagePool(ecfg.n_pages)
        self.sessions = SessionStore(policy=session_policy, device=device)
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self._pages: dict[int, list[int]] = {}
        self.caches = init_caches(cfg, ecfg.max_batch, ecfg.max_seq,
                                  device=device)
        self._slot_rid: list[int | None] = [None] * ecfg.max_batch
        self.steps = 0

    def _decode(self, tok: np.ndarray) -> torch.Tensor:
        """One whole-batch decode step on the host token batch ``tok``
        (max_batch, 1); returns the logits, left on the device."""
        with torch.inference_mode():
            logits, self.caches = decode_step(
                self.params, self.cfg, self.caches,
                tokens=upload(tok, self.device))
        return logits

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and None in self._slot_rid:
            req = self.queue.pop(0)
            slot = self._slot_rid.index(None)
            self._slot_rid[slot] = req.rid
            self.active[req.rid] = req
            n_pages = -(-int(req.prompt.shape[0] + req.max_new)
                        // self.ecfg.page_tokens)
            pages = self.pool.alloc(n_pages)
            self._pages[req.rid] = pages
            self.sessions.register_batch(
                np.array([req.rid]),
                [PageRecord(pages[0], len(pages), req.prompt.shape[0])])
            # prefill: feed prompt tokens one-by-one into this slot's cache
            # (slot-local decode warmup, as in the reference)
            for t in req.prompt:
                tok = np.zeros((self.ecfg.max_batch, 1), np.int32)
                tok[slot, 0] = t
                self._decode(tok)

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """One engine iteration; returns number of active sequences."""
        self._admit()
        rids = [r for r in self._slot_rid if r is not None]
        if not rids:
            return 0
        # learned-index lookup of every active session's page record
        found, recs = self.sessions.lookup_batch(np.array(rids, np.int64))
        if not found.all():
            raise RuntimeError("active session missing from the store")
        tok = np.zeros((self.ecfg.max_batch, 1), np.int32)
        for slot, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            req = self.active[rid]
            last = req.generated[-1] if req.generated else int(req.prompt[-1])
            tok[slot, 0] = last
        logits = self._decode(tok)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        for slot, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            req = self.active[rid]
            req.generated.append(int(nxt[slot]))
            if len(req.generated) >= req.max_new or \
                    int(nxt[slot]) == self.ecfg.eos_token:
                req.done = True
                self.pool.release(self._pages.pop(rid))
                self.sessions.evict_batch(np.array([rid]))
                self._slot_rid[slot] = None
                del self.active[rid]
        self.steps += 1
        return len(self.active)

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            self.step()
