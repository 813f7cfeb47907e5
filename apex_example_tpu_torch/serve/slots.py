"""Block-paged KV cache: port of apex_example_tpu/serve/slots.py.

Every layer owns one K and one V arena of shape
``[num_blocks, block_size, heads, head_dim]``, torch tensors on the
model's device; a request maps only the blocks its sequence touches,
through a per-slot block table (``[SLOTS, max_blocks]``) that the paged
attention gathers through (models/bert.py).  The arenas are updated in
place by the model's paged step — COW copies, K/V scatter — where the JAX
package threads new cache trees through its compiled step.

The host policy is the JAX package's, in numpy and Python, unchanged:

- **Free-list allocation** with per-block refcounts.  Admission reserves a
  request's worst-case block count up front (``ceil((prompt + max_new) /
  block_size)`` minus fully-shared blocks), so a decoding slot never runs
  out of blocks mid-flight: out-of-blocks resolves at admission.
- **Prefix sharing** (copy-on-write): full blocks are registered in a
  chain-keyed index (each key hashes the block's tokens AND its whole
  prefix).  A new request maps the longest indexed chain covering its
  prompt, including a partial overlap into one more indexed block; blocks
  mapped by several slots (or cached in the index) are immutable, and the
  first write into one copies it inside the step (``cow_*`` pairs).
  Zero-ref indexed blocks linger as an LRU-evicted reusable cache.
- **Chunked prefill**: the engine feeds up to ``block_size`` prompt tokens
  per tick; ``stage_writes``/``commit_writes`` bracket each tick's span.

Shared prefixes stop one token short of the full prompt: the first
generated token is sampled from the logits after the last prompt token.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_example_tpu_torch.serve.queue import Request


@dataclass
class BlockNode:
    """One indexed (full, immutable) block: its chain key encodes the
    block's tokens and, through ``parent``, every token before it."""

    bid: int
    key: Tuple
    parent: Optional[Tuple]
    tokens: Tuple[int, ...]


class BlockAllocator:
    """Free-list + refcount + prefix-index bookkeeping for one arena.

    Pure host code.  Determinism contract: allocation order, LRU eviction
    order and prefix-match tie-breaks depend only on the call sequence, so
    a rerun of the same request stream allocates identically.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcount = [0] * num_blocks
        self._immutable = [False] * num_blocks
        self._free: List[int] = list(range(num_blocks))[::-1]  # pop()=0 first
        # Zero-ref indexed blocks, LRU order (oldest first): reusable
        # prefix cache, evicted only when the free list runs dry.
        self._reusable: "OrderedDict[int, BlockNode]" = OrderedDict()
        self._index: Dict[Tuple, BlockNode] = {}
        self._children: Dict[Optional[Tuple], List[BlockNode]] = {}
        self._nodes: Dict[int, BlockNode] = {}   # bid -> node (indexed only)

    @property
    def blocks_in_use(self) -> int:
        """Blocks currently mapped by at least one slot."""
        return self.num_blocks - len(self._free) - len(self._reusable)

    def available(self, revive: Tuple[int, ...] = ()) -> int:
        """Blocks an admission could still draw from: the free list plus
        the evictable reusable cache, minus any of ``revive`` that sit in
        that cache (mapping them removes them from the evictable pool)."""
        revived = sum(1 for b in set(revive) if b in self._reusable)
        return len(self._free) + len(self._reusable) - revived

    def immutable(self, bid: int) -> bool:
        return self._immutable[bid]

    def alloc(self) -> int:
        """One fresh mutable block (refcount 1): the free list first, then
        the least-recently-freed reusable block (deregistered).  Raising
        here means the caller's reservation accounting is broken."""
        if self._free:
            bid = self._free.pop()
        elif self._reusable:
            bid, node = self._reusable.popitem(last=False)
            self._deregister(node)
        else:
            raise RuntimeError(
                "out of KV blocks — admission reserves worst-case block "
                "budgets, so this is an allocator accounting bug")
        self.refcount[bid] = 1
        self._immutable[bid] = False
        return bid

    def ref(self, bid: int) -> None:
        """Map a cached block into one more slot (prefix sharing)."""
        self.refcount[bid] += 1
        self._reusable.pop(bid, None)

    def unref(self, bid: int) -> None:
        """Drop one mapping.  At zero refs an indexed block parks in the
        reusable cache; an unindexed one returns to the free list."""
        if self.refcount[bid] < 1:
            raise RuntimeError(f"unref of free block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            node = self._nodes.get(bid)
            if node is not None:
                self._reusable[bid] = node
            else:
                self._free.append(bid)

    def _deregister(self, node: BlockNode) -> None:
        del self._index[node.key]
        self._children[node.parent].remove(node)
        if not self._children[node.parent]:
            del self._children[node.parent]
        del self._nodes[node.bid]

    def register_full(self, parent: Optional[Tuple],
                      tokens: Tuple[int, ...], bid: int) -> Tuple:
        """Index a block that just filled (immutable from here on).  A
        duplicate chain keeps the first index entry; the duplicate block
        stays unindexed and frees normally."""
        if len(tokens) != self.block_size:
            raise ValueError(f"register_full wants exactly "
                             f"{self.block_size} tokens, got {len(tokens)}")
        key = (parent, tokens)
        self._immutable[bid] = True
        if key not in self._index:
            node = BlockNode(bid, key, parent, tokens)
            self._index[key] = node
            self._children.setdefault(parent, []).append(node)
            self._nodes[bid] = node
        return key

    def match_prefix(self, prompt) -> Tuple[int, List[int], List[Tuple]]:
        """Longest cached prefix of ``prompt``: ``(shared_len, block ids,
        chain keys)`` — exact full-block chain matches, then a partial
        overlap into one more indexed child block (first registered child
        with the longest common prefix wins).  Capped at
        ``len(prompt) - 1`` so the last prompt token is re-fed."""
        BS = self.block_size
        bids: List[int] = []
        keys: List[Tuple] = []
        parent: Optional[Tuple] = None
        shared = 0
        for b in range(len(prompt) // BS):
            key = (parent, tuple(prompt[b * BS:(b + 1) * BS]))
            node = self._index.get(key)
            if node is None:
                break
            bids.append(node.bid)
            keys.append(key)
            parent = key
            shared += BS
        rest = tuple(prompt[shared:shared + BS])
        best, best_j = None, 0
        for node in self._children.get(parent, []):
            j = 0
            while j < len(rest) and node.tokens[j] == rest[j]:
                j += 1
            if j > best_j:
                best, best_j = node, j
        if best is not None:
            bids.append(best.bid)
            keys.append(best.key)
            shared += best_j
        shared = min(shared, len(prompt) - 1)
        n_mapped = math.ceil(shared / BS) if shared else 0
        return shared, bids[:n_mapped], keys[:n_mapped]


@dataclass
class Slot:
    """Host-side state of one live request in a slot.

    ``tokens`` is the full sequence (prompt + generated so far); ``cursor``
    counts tokens whose KV is in the arena.  During decode
    ``len(tokens) == cursor + 1``; during prefill ``cursor < n_prompt``.
    ``block_keys`` parallels the mapped blocks: the chain key of a
    registered block, None for a mutable block still filling.
    """

    request: Request
    admitted_step: int
    t_admitted: float
    tokens: List[int] = field(default_factory=list)
    cursor: int = 0
    n_generated: int = 0
    t_first_token: Optional[float] = None
    shared_len: int = 0
    n_mapped: int = 0
    reserved: int = 0
    block_keys: List[Optional[Tuple]] = field(default_factory=list)

    @property
    def n_prompt(self) -> int:
        return len(self.request.prompt)

    @property
    def prefilling(self) -> bool:
        return self.cursor < self.n_prompt


class BlockPool:
    """``num_slots`` request slots over one block-paged KV arena per layer.

    ``model`` is the port's GPTForCausalLM; the arenas are allocated on its
    device in its dtype.  ``num_blocks`` defaults to the dense layout's
    capacity, ``num_slots * ceil(max_len / block_size)``.
    """

    def __init__(self, model, num_slots: int, max_len: int,
                 block_size: int = 8, num_blocks: Optional[int] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if model.max_position < max_len:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"position table ({model.max_position})")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_blocks = math.ceil(max_len / block_size)
        if num_blocks is None:
            num_blocks = num_slots * self.max_blocks
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.num_blocks = num_blocks
        param = model.word_embeddings.weight
        shape = (num_blocks, block_size, model.num_heads,
                 model.hidden_size // model.num_heads)
        self.arenas = [
            (torch.zeros(shape, dtype=param.dtype, device=param.device),
             torch.zeros(shape, dtype=param.dtype, device=param.device))
            for _ in range(model.num_layers)]
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.table = np.zeros((num_slots, self.max_blocks), np.int32)
        self.slots: List[Optional[Slot]] = [None] * num_slots
        self._free: List[int] = list(range(num_slots))[::-1]  # pop()=slot 0
        self._reserved_total = 0
        self.cow_copies = 0
        self._shared_tokens = 0
        self._prompt_tokens = 0

    # ------------------------------------------------------------ state

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def any_live(self) -> bool:
        return len(self._free) < self.num_slots

    # ---------------------------------------------------- block budgets

    def max_new_for(self, request: Request) -> int:
        """Effective output budget: the request's ask, clamped so the
        total sequence fits a slot's logical capacity."""
        return min(request.max_new_tokens,
                   self.max_len - len(request.prompt))

    def blocks_needed(self, request: Request, shared_len: int = 0) -> int:
        """Worst-case blocks this request will ALLOCATE over its lifetime:
        blocks covering the clamped total sequence, minus fully-shared
        blocks (a partially-overlapped shared block still costs its COW
        copy)."""
        total = len(request.prompt) + self.max_new_for(request)
        return math.ceil(total / self.block_size) \
            - shared_len // self.block_size

    def fits(self, request: Request) -> bool:
        """Could this request EVER be admitted (worst case, no sharing)?
        False means admission must reject it outright."""
        return self.max_new_for(request) >= 1 \
            and self.blocks_needed(request) <= self.num_blocks

    def can_admit(self, request: Request) -> bool:
        """Slot free AND the worst-case block budget (after prefix
        sharing) is coverable by unreserved blocks right now."""
        if not self._free:
            return False
        shared, bids, _ = self.alloc.match_prefix(request.prompt)
        need = self.blocks_needed(request, shared)
        return self.alloc.available(tuple(bids)) \
            - self._reserved_total >= need

    # -------------------------------------------------------- lifecycle

    def admit(self, request: Request, step: int) -> int:
        """Insert ``request`` into a free slot: map its shared prefix
        blocks (refcounted), reserve its worst-case allocation budget and
        seed the host state.  Returns the slot id.  The engine gates on
        ``fits``/``can_admit`` first."""
        if not self._free:
            raise RuntimeError("no free slot (admission must check "
                               "free_count first)")
        n_prompt = len(request.prompt)
        if n_prompt >= self.max_len:
            raise ValueError(
                f"{request.uid}: prompt length {n_prompt} must be < "
                f"cache max_len {self.max_len} (admission should have "
                "rejected this request)")
        shared, bids, keys = self.alloc.match_prefix(request.prompt)
        need = self.blocks_needed(request, shared)
        idx = self._free.pop()
        for b in bids:
            self.alloc.ref(b)
        self.table[idx, :] = 0
        self.table[idx, :len(bids)] = bids
        self.slots[idx] = Slot(request=request, admitted_step=step,
                               t_admitted=time.perf_counter(),
                               tokens=[int(t) for t in request.prompt],
                               cursor=shared, shared_len=shared,
                               n_mapped=len(bids), reserved=need,
                               block_keys=list(keys))
        self._reserved_total += need
        self._shared_tokens += shared
        self._prompt_tokens += n_prompt
        return idx

    def evict(self, idx: int) -> None:
        """Free a slot: unref its mapped blocks (full indexed ones park in
        the reusable prefix cache) and release the unspent reservation."""
        slot = self.slots[idx]
        if slot is None:
            raise RuntimeError(f"slot {idx} is already free")
        for b in range(slot.n_mapped):
            self.alloc.unref(int(self.table[idx, b]))
        self._reserved_total -= slot.reserved
        self.table[idx, :] = 0
        self.slots[idx] = None
        self._free.append(idx)

    def _alloc_for(self, slot: Slot) -> int:
        if slot.reserved < 1:
            raise RuntimeError(
                f"{slot.request.uid}: write past the reserved block "
                "budget — blocks_needed accounting bug")
        bid = self.alloc.alloc()
        slot.reserved -= 1
        self._reserved_total -= 1
        return bid

    def stage_writes(self, idx: int, n_new: int) -> Tuple[int, int]:
        """Pre-step: make every block covering write positions ``[cursor,
        cursor + n_new)`` mapped and mutable for slot ``idx``.  Returns the
        tick's COW pair ``(src, dst)``, ``(-1, -1)`` when no shared block
        is written.  At most one COW per slot per tick: only the first
        written block can be shared."""
        slot = self.slots[idx]
        cow = (-1, -1)
        start, end = slot.cursor, slot.cursor + n_new
        BS = self.block_size
        for b in range(start // BS, (end - 1) // BS + 1):
            if b < slot.n_mapped:
                bid = int(self.table[idx, b])
                if self.alloc.immutable(bid):
                    new = self._alloc_for(slot)
                    cow = (bid, new)
                    self.alloc.unref(bid)
                    self.table[idx, b] = new
                    slot.block_keys[b] = None     # content diverges
                    self.cow_copies += 1
            else:
                if b != slot.n_mapped:
                    raise RuntimeError("non-contiguous block mapping")
                self.table[idx, b] = self._alloc_for(slot)
                slot.block_keys.append(None)
                slot.n_mapped += 1
        return cow

    def commit_writes(self, idx: int, n_new: int) -> None:
        """Post-step: advance the slot's fill cursor and register every
        block that just became full in the prefix index."""
        slot = self.slots[idx]
        slot.cursor += n_new
        BS = self.block_size
        for b in range(slot.n_mapped):
            if slot.block_keys[b] is None and (b + 1) * BS <= slot.cursor:
                parent = slot.block_keys[b - 1] if b else None
                toks = tuple(slot.tokens[b * BS:(b + 1) * BS])
                slot.block_keys[b] = self.alloc.register_full(
                    parent, toks, int(self.table[idx, b]))

    # ---------------------------------------------------- KV accounting

    def kv_bytes_reserved(self) -> int:
        """Device bytes the arenas pin for the engine's lifetime."""
        return sum(t.numel() * t.element_size()
                   for arena in self.arenas for t in arena)

    def kv_bytes_per_token(self) -> int:
        """Bytes one cached token occupies across every layer's K and V
        arena."""
        return self.kv_bytes_reserved() \
            // (self.num_blocks * self.block_size)

    def kv_bytes_per_token_bf16(self) -> int:
        """What one cached token would cost in a bf16 arena of this
        geometry (2 bytes per K/V element)."""
        elems = sum(t.numel() for arena in self.arenas for t in arena)
        return elems * 2 // (self.num_blocks * self.block_size)

    @property
    def kv_dtype(self) -> str:
        """The arena payload dtype name, spelled as numpy spells it."""
        if not self.arenas:
            return "none"
        return str(self.arenas[0][0].dtype).replace("torch.", "")

    def kv_bytes_live(self) -> int:
        """Bytes of KV the live slots logically hold (a shared block's
        tokens count once per sharer)."""
        return sum(s.cursor for s in self.slots if s is not None) \
            * self.kv_bytes_per_token()

    def blocks_live(self) -> int:
        """Arena blocks physically held by live slots right now."""
        return self.alloc.blocks_in_use

    def blocks_committed(self) -> int:
        """Blocks physically held plus reserved-but-unallocated budget."""
        return self.alloc.blocks_in_use + self._reserved_total

    def prefix_hit_rate(self) -> float:
        """Shared prompt tokens / total prompt tokens over every admission
        so far (0.0 before any admission)."""
        if not self._prompt_tokens:
            return 0.0
        return self._shared_tokens / self._prompt_tokens
