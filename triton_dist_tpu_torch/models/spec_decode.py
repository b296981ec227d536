"""Speculative decoding: n-gram self-drafting and greedy acceptance of a
batched multi-token verify over the slot caches (contiguous and paged).

Counterpart of triton_dist_tpu/models/spec_decode.py (`Drafter`,
`NgramDrafter`, `accept_greedy`). A drafter proposes up to K next tokens
per slot on the host; one verify forward (Engine.slot_verify_chunk /
paged_slot_verify_chunk, over the window forms of the flash kernels)
scores every slot's window; `accept_greedy` keeps the drafts that equal
the verify argmax, so every emitted token is an argmax of the target
logits, as with spec=0. Rollback is positional: a rejected suffix stays
as dead KV rows past the slot's rewound length, never attended and
overwritten by the next window.

Sampled acceptance (`target_probs`, `accept_sampled`) waits for sampled
decoding and raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence

import numpy as np
import torch


class Drafter(Protocol):
    """Draft source: given a slot's token history (prompt + everything
    emitted, including the pending next token), propose up to k likely
    continuation tokens (fewer or none is fine; the scheduler pads and
    masks). Implementations must be deterministic."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        ...


class NgramDrafter:
    """Prompt-lookup / n-gram self-drafting: find the most recent earlier
    occurrence of the history's trailing n-gram (longest n first) and
    propose the tokens that followed it. `window` bounds the lookup to the
    last `window` history tokens."""

    def __init__(self, max_n: int = 3, min_n: int = 1, window: int = 1024):
        assert 1 <= min_n <= max_n
        self.max_n = max_n
        self.min_n = min_n
        self.window = window

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = np.asarray(history)
        L = len(h)
        if k <= 0 or L < self.min_n + 1:
            return []
        base = max(0, L - self.window)
        win = h[base:]
        W = len(win)
        for n in range(min(self.max_n, L - base - 1), self.min_n - 1, -1):
            tail = win[-n:]
            # candidate starts j = 0 .. W - n - 1 (the tail itself is excluded)
            hit = np.ones((W - n,), bool)
            for o in range(n):
                hit &= win[o:W - n + o] == tail[o]
            idx = np.nonzero(hit)[0]
            if len(idx):
                j = int(idx[-1])           # the most recent occurrence
                return [int(t) for t in win[j + n:j + n + k]]
        return []


def accept_greedy(tokens: torch.Tensor, nxt: torch.Tensor, q_lens: torch.Tensor):
    """Greedy acceptance over one verify window. tokens: [B, S], the window
    fed to the forward (seed at column 0, drafts after); nxt: [B, S], the
    per-position argmax of the verify logits (nxt[:, s] follows
    tokens[:, :s+1]); q_lens: [B] valid window lengths. Returns (n_emit
    [B], seed plus accepted drafts, 1..q_lens; t0_next [B], the argmax
    after the kept prefix, the next window's seed), int32."""
    S = tokens.shape[1]
    ok = (tokens[:, 1:] == nxt[:, :-1]) \
        & (torch.arange(1, S, device=tokens.device)[None] < q_lens[:, None])
    acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    t0_next = torch.gather(nxt, 1, acc[:, None].long())[:, 0]
    return (1 + acc).to(torch.int32), t0_next.to(torch.int32)


def target_probs(*args, **kw):
    raise NotImplementedError("spec_decode.target_probs (sampled speculative "
                              "decoding): not yet ported")


def accept_sampled(*args, **kw):
    raise NotImplementedError("spec_decode.accept_sampled (sampled speculative "
                              "decoding): not yet ported")
