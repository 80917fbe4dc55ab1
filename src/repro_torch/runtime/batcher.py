"""Continuous-batching serving scheduler with a compression-aware paged KV
pool (DESIGN.md §9), in torch.

Port of `repro.runtime.batcher`. Two cache layouts behind one scheduler:

* **Paged** (the serving tier, default when the model supports it): each
  slot owns a page table over a shared per-layer page arena, and the
  position clock is a per-slot vector, so requests at different depths
  decode in one batch and admission happens mid-wave the moment a slot
  frees. Page pressure preempts the youngest-admitted request (LIFO, so
  the oldest always progresses); its pages are compressed on evict
  (`kvcomp.compress_page`) under the request's `Policy`, resolved once
  at admission from a `PolicySet` via `request_kv_name` (long-context
  requests take `fixed_ratio` byte budgets, short ones stay raw), and
  decompressed back into freshly allocated pages on resume. Pages freeze
  once decode moves past them, so re-evicting an unchanged page reuses
  its `CompressedPage`.

* **Legacy contiguous** (`paged=False`): the fixed `slots x max_len`
  cache with a shared scalar clock; new requests join at clock zero only.
  Every family serves on it (the recurrent ones, xLSTM and the hybrid,
  have no paged cache): a batch-1 prefill's cache is spliced into the
  slot leaf by leaf (`splice_rows`).

The arenas live on the model's device. An evicted page stack is sliced
out of the arena there, ``(n_layers, page_tokens, n_kv_heads * head_dim)``,
and compressed on that device (on the GPU a lossy stack runs the fused
BOT kernel K6); a restored page is written back into the arena in place.
The scheduler's bookkeeping (page lists, clocks, page tables) lives on the
host and reaches the device once per decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.policy import Policy, PolicySet, as_policy_set, request_kv_name
from . import kvcomp


#: (short key, cache stack, tensor) of every arena whose pages evict
_ARENA_KEYS = (("k", "blocks", "k"), ("v", "blocks", "v"),
               ("dk", "dense_blocks", "k"), ("dv", "dense_blocks", "v"))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # serving-tier state (paged pool, DESIGN.md §9)
    policy: Any = None  # quality contract, resolved once at admission
    pname: str = ""  # canonical policy leaf name (request_kv_name)
    resume_len: int = 0  # context tokens held compressed after preemption
    page_comp: dict = dataclasses.field(default_factory=dict)
    evictions: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over a shared decode step.

    Paged mode: the model's cache is `slots` per-slot clocks + page tables
    over `arena_pages` shared pages of `page_tokens` tokens per layer
    (page 0 is reserved scratch for dead slots). Prefill runs batch-1
    against a contiguous sub-cache and is spliced into the slot's pages.

    `policies` (a `Policy` or `PolicySet`) is resolved per request at
    admission under the name `request_kv_name(rid, prompt+max_new,
    long_threshold)`; the resolved policy drives compress-on-evict.
    `decisions` is an optional `DecisionCache` for warm-path bound replay
    on re-evicted frozen pages (DESIGN.md §8.2).
    """

    def __init__(
        self,
        model,
        params,
        slots: int,
        max_len: int,
        eos_id: int = 0,
        *,
        paged: bool | None = None,
        page_tokens: int = 16,
        arena_pages: int | None = None,
        policies: Policy | PolicySet | None = None,
        long_threshold: int = 256,
        decisions=None,
    ):
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        if paged is None:
            cfg = getattr(model, "cfg", None)
            paged = (
                hasattr(model, "paged_cache_desc")
                and cfg is not None
                and getattr(cfg, "mla", None) is None
                and not getattr(cfg, "kv_quant", False)
            )
        self.paged = bool(paged)
        self.live = np.zeros(slots, dtype=bool)
        self.requests: dict[int, Request] = {}
        self.slot_req = [-1] * slots
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
        self.preempted: list[Request] = []
        self.stats = {"evictions": 0, "restores": 0, "page_reuses": 0}
        if self.paged:
            self.page_tokens = int(page_tokens)
            self.max_pages = -(-max_len // self.page_tokens)
            self.arena_pages = int(arena_pages or slots * self.max_pages)
            if self.arena_pages < self.max_pages:
                raise ValueError(
                    f"arena_pages={self.arena_pages} < max_pages="
                    f"{self.max_pages}: one max-length request must always fit"
                )
            self.cache = model.init_paged_cache(
                slots, self.arena_pages, self.page_tokens, self.max_pages
            )
            # allocator hands out ids 1..arena_pages (0 = scratch), low first
            self.free_pages = list(range(self.arena_pages, 0, -1))
            self.slot_pages: list[list[int]] = [[] for _ in range(slots)]
            self.slot_len = np.zeros(slots, np.int32)
            self.ptab_host = np.zeros((slots, self.max_pages), np.int32)
            self.admit_seq = np.zeros(slots, np.int64)
            self._seq = 0
            self.policies = as_policy_set(policies if policies is not None else Policy.raw())
            self.long_threshold = int(long_threshold)
            self.decisions = decisions
        else:
            if policies is not None or decisions is not None:
                raise ValueError("policies=/decisions= need the paged KV pool (paged=True)")
            self.cache = model.init_cache(slots, max_len)

    def _decode(self, params, tokens, cache):
        logits, cache = self.model.forward(params, {"tokens": tokens}, cache=cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    # -- paged arena plumbing ------------------------------------------------

    def _arenas(self, cache=None):
        """(short key, arena tensor (n_layers, pages + 1, T, hkv, dh)) per
        arena whose pages evict, in the reference's order: the stacked
        layers' K and V, then the leading dense layers' (an MoE config's
        `dense_blocks`). Of `cache` (default the batcher's): a contiguous
        sub-cache gives its (n_layers, 1, M, hkv, dh) stacks in the same
        order."""
        cache = self.cache if cache is None else cache
        return [(key, cache[stack][name]) for key, stack, name in _ARENA_KEYS if stack in cache]

    def _prefill(self, prompt: np.ndarray):
        """Batch-1 contiguous prefill; returns (first token, sub-cache)."""
        L = len(prompt)
        if self.paged:
            sub_len = -(-L // self.page_tokens) * self.page_tokens
        else:
            sub_len = self.max_len
        sub = self.model.init_cache(1, sub_len)
        tokens = torch.as_tensor(np.asarray(prompt, np.int32), device=self.device)[None]
        logits, sub = self.model.forward(self.params, {"tokens": tokens}, cache=sub)
        return int(torch.argmax(logits[0, -1])), sub

    def _splice_prefill(self, sub, pids: list[int]) -> None:
        """Copy a contiguous batch-1 prefill cache into arena pages."""
        pt = self.page_tokens
        npg = len(pids)
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        for (_, arena), (_, src) in zip(self._arenas(), self._arenas(sub)):
            # src: (nl, 1, npg*pt, hkv, dh)
            s = src[:, 0].reshape((src.shape[0], npg, pt) + tuple(src.shape[3:]))
            arena.index_copy_(1, idx, s.to(arena.dtype))

    def _free_slot_pages(self, slot: int) -> None:
        self.free_pages.extend(reversed(self.slot_pages[slot]))
        self.slot_pages[slot] = []
        self.ptab_host[slot, :] = 0
        self.slot_len[slot] = 0

    # -- compress-on-evict / decompress-on-hit (DESIGN.md §9) ----------------

    def _evict(self, slot: int) -> None:
        """Preempt the request in `slot`: compress its pages, free them."""
        rid = self.slot_req[slot]
        req = self.requests[rid]
        pt = self.page_tokens
        lens = int(self.slot_len[slot])
        nstore = -(-lens // pt)
        for key, arena in self._arenas():
            for p in range(nstore):
                cp = req.page_comp.get((key, p))
                if cp is not None and cp.clean and (p + 1) * pt <= lens:
                    # frozen since restore: its compressed form still holds
                    self.stats["page_reuses"] += 1
                    continue
                pid = self.slot_pages[slot][p]
                # the stack stays on the arena's device: (nl, pt, hkv*dh)
                page = arena[:, pid].reshape(arena.shape[0], pt, -1)
                req.page_comp[(key, p)] = kvcomp.compress_page(
                    page,
                    req.policy,
                    cache=self.decisions,
                    name=f"{req.pname}/{key}{p}",
                    device=self.device,
                )
        req.resume_len = lens
        req.evictions += 1
        self._free_slot_pages(slot)
        self.live[slot] = False
        self.slot_req[slot] = -1
        self.preempted.append(req)
        self.stats["evictions"] += 1

    def _preempt_one(self, exclude: tuple[int, ...] = ()) -> bool:
        """Evict the youngest-admitted live slot (LIFO keeps the oldest
        request progressing, which bounds restart churn)."""
        cands = [s for s in range(self.slots) if self.live[s] and s not in exclude]
        if not cands:
            return False
        self._evict(max(cands, key=lambda s: int(self.admit_seq[s])))
        return True

    def _resume(self, req: Request, slot: int) -> bool:
        """Decompress a preempted request's pages into fresh arena pages."""
        pt = self.page_tokens
        lens = req.resume_len
        need = lens // pt + 1
        if len(self.free_pages) < need:
            return False
        pids = [self.free_pages.pop() for _ in range(need)]
        nstore = -(-lens // pt)
        for key, arena in self._arenas():
            for p in range(nstore):
                page = kvcomp.decompress_page(req.page_comp[(key, p)], device=self.device)
                arena[:, pids[p]] = page.reshape(arena[:, 0].shape).to(arena.dtype)
        # arena now equals the store: frozen pages are reusable at the next
        # evict; the partial tail page will be rewritten, so drop it
        for k in list(req.page_comp):
            if (k[1] + 1) * pt <= lens:
                req.page_comp[k].clean = True
            else:
                del req.page_comp[k]
        req.resume_len = 0
        self._bind(req, slot, pids, lens, int(req.out[-1]))
        self.stats["restores"] += 1
        return True

    def _bind(self, req, slot, pids, lens, next_tok):
        self.slot_pages[slot] = pids
        self.ptab_host[slot, :] = 0
        self.ptab_host[slot, : len(pids)] = pids
        self.slot_len[slot] = lens
        self.tokens[slot, 0] = next_tok
        self.live[slot] = True
        self.slot_req[slot] = req.rid
        self.admit_seq[slot] = self._seq
        self._seq += 1
        self.requests[req.rid] = req

    # -- admission ----------------------------------------------------------

    def try_admit(self, req: Request) -> bool:
        """Admit into a free slot (or resume a preempted request). With the
        paged pool, per-slot clocks make admission legal mid-wave; the
        legacy contiguous cache shares one scalar clock, so new requests
        join at clock zero only."""
        if self.paged:
            return self._admit_paged(req)
        return self._admit_legacy(req)

    def _admit_paged(self, req: Request) -> bool:
        free = [i for i in range(self.slots) if not self.live[i]]
        if not free:
            return False
        if req.resume_len:
            return self._resume(req, free[0])
        pt = self.page_tokens
        L = int(len(req.prompt))
        need = L // pt + 1
        if need > self.max_pages:
            raise ValueError(
                f"prompt of {L} tokens needs {need} pages > max_pages="
                f"{self.max_pages} (max_len={self.max_len})"
            )
        if req.max_new > 1 and len(self.free_pages) < need:
            return False
        # resolve the quality contract once, for the request's lifetime
        req.pname = request_kv_name(req.rid, L + req.max_new, self.long_threshold)
        req.policy = self.policies.resolve(req.pname)
        nxt, sub = self._prefill(req.prompt)
        req.out.append(nxt)
        self.requests[req.rid] = req
        if nxt == self.eos_id or req.max_new <= 1:
            # EOS (or a 1-token budget) at prefill terminates at admission:
            # no decode slot, no pages
            req.done = True
            return True
        pids = [self.free_pages.pop() for _ in range(need)]
        self._splice_prefill(sub, pids[: -(-L // pt)])
        self._bind(req, free[0], pids, L, nxt)
        return True

    def _admit_legacy(self, req: Request) -> bool:
        free = [i for i in range(self.slots) if not self.live[i]]
        if not free:
            return False
        if self.live.any() and int(self.cache["pos"]) > 0:
            return False  # mid-wave admission needs per-slot clocks (paged)
        nxt, sub_cache = self._prefill(req.prompt)
        req.out.append(nxt)
        self.requests[req.rid] = req
        if nxt == self.eos_id or req.max_new <= 1:
            req.done = True
            return True
        if not self.live.any() and int(self.cache["pos"]) > 0:
            self.cache = self.model.init_cache(self.slots, self.max_len)  # reset
        slot = free[0]
        splice_rows(self.cache, sub_cache, slot, self.slots)
        self.cache["pos"] = torch.maximum(self.cache["pos"], sub_cache["pos"])  # shared clock
        self.tokens[slot, 0] = nxt
        self.live[slot] = True
        self.slot_req[slot] = req.rid
        return True

    # -- one decode iteration over all live slots ----------------------------

    def _ensure_decode_pages(self) -> None:
        """Give every live slot a page for its next write position; page
        pressure preempts LIFO (never the slot being served first, and the
        arena >= max_pages invariant guarantees the oldest always fits)."""
        order = sorted(
            (s for s in range(self.slots) if self.live[s]),
            key=lambda s: int(self.admit_seq[s]),
        )
        for slot in order:
            if not self.live[slot]:
                continue  # preempted while serving an older slot
            need_idx = int(self.slot_len[slot]) // self.page_tokens
            if need_idx < len(self.slot_pages[slot]):
                continue
            if need_idx >= self.max_pages:
                self._finish(slot)  # page table exhausted: hit max_len
                continue
            while not self.free_pages:
                if not self._preempt_one(exclude=(slot,)):
                    raise RuntimeError(
                        "paged KV pool deadlock: no free pages and no "
                        "preemptable slot (arena_pages too small?)"
                    )
            pid = self.free_pages.pop()
            self.slot_pages[slot].append(pid)
            self.ptab_host[slot, need_idx] = pid

    def _finish(self, slot: int) -> None:
        rid = self.slot_req[slot]
        req = self.requests[rid]
        req.done = True
        if self.paged:
            self._free_slot_pages(slot)
            req.page_comp.clear()
        self.live[slot] = False
        self.slot_req[slot] = -1

    def step(self) -> list[int]:
        """Advance every live slot one token; returns finished rids."""
        if not self.live.any():
            return []
        if self.paged:
            self._ensure_decode_pages()
            if not self.live.any():
                return []
            # copies: the host arrays move on while the device reads these
            self.cache["pos"] = torch.tensor(self.slot_len, device=self.device)
            self.cache["page_table"] = torch.tensor(self.ptab_host, device=self.device)
        nxt, self.cache = self._decode(self.params, self.tokens, self.cache)
        self.tokens = nxt
        emitted = nxt[:, 0].tolist()  # one device-to-host copy per step
        finished = []
        for slot in range(self.slots):
            if not self.live[slot]:
                continue
            rid = self.slot_req[slot]
            req = self.requests[rid]
            tok = emitted[slot]
            req.out.append(tok)
            if self.paged:
                self.slot_len[slot] += 1
            # limit counts emitted tokens (prefill token included), so a
            # request with max_new=N receives exactly N tokens
            if tok == self.eos_id or len(req.out) >= req.max_new:
                self._finish(slot)
                finished.append(rid)
        return finished

    # -- accounting ----------------------------------------------------------

    def resident_kv_bytes(self) -> int:
        """Resident-KV accounting (the serving benchmark's metric): live
        arena pages at raw size + the compressed store held by preempted
        requests (`CompressedPage.nbytes` is exact bit accounting from the
        kernel, or exact bytes for raw pages)."""
        if not self.paged:
            return sum(t.numel() * t.element_size() for t in _leaves(self.cache))
        per_page = sum(a.numel() // a.shape[1] * a.element_size() for _, a in self._arenas())
        live_pages = sum(len(p) for p in self.slot_pages)
        comp = sum(cp.nbytes for r in self.preempted for cp in r.page_comp.values())
        return live_pages * per_page + comp

    # -- driver --------------------------------------------------------------

    def run(self, reqs: list[Request], max_iters: int = 10_000) -> list[Request]:
        """Drive a full workload: admit when slots free, decode until done.
        Preempted requests resume ahead of fresh admissions (their context
        is already paid for)."""
        pending = list(reqs)
        it = 0
        while (pending or self.preempted or self.live.any()) and it < max_iters:
            while self.preempted and self.try_admit(self.preempted[0]):
                self.preempted.pop(0)
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            self.step()
            it += 1
        return reqs


def splice_rows(main, sub, slot: int, slots: int) -> None:
    """Copy every leaf of the batch-1 cache tree `sub` into row `slot` of
    the `slots`-row tree `main` (the same keys, nested to any depth), in
    place, along the first axis whose size is 1 in `sub` and `slots` in
    `main` (the reference's rule: axis 1 of a layer stack, axis 2 of the
    hybrid's (groups, layers, B, ...) and xLSTM's (groups, blocks, B, ...)
    stacks). 0-d leaves, the clock, have no such axis and are left alone."""
    if isinstance(sub, dict):
        for key, s in sub.items():
            splice_rows(main[key], s, slot, slots)
        return
    for ax in range(sub.ndim):
        if sub.shape[ax] == 1 and main.shape[ax] == slots:
            main.narrow(ax, slot, 1).copy_(sub)
            return


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
