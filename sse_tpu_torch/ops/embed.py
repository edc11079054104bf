"""The table gradient of an embedding lookup, ``table[tokens]``'s
cotangent for ``embed_grad="take"``: ``dt[v]`` is the float32 sum of the
cotangent rows at every position whose token is ``v`` (zero where no token
names ``v``).

``table_grad`` on CUDA tensors sorts the ids stably once and launches
``csrc/embed_grad.cu``: a deterministic segmented sum cut by position in
the sorted list, so that a long run of one id (the pad id's) is spread over
as many warps as it fills. There are no atomics: the order of every sum is
a function of the ids alone, and the result has the same bits on every
run, eager or in a replayed CUDA graph. On CPU tensors it runs
``table_grad_reference``, the same sums in the same order in plain
PyTorch. The port's CPU training path takes neither: there the tower's
``table[tokens]`` keeps autograd's own backward (``models/towers.py``
``_embed``).
"""

from __future__ import annotations

import ctypes

import torch

from sse_tpu_torch.ops import _build
from sse_tpu_torch.ops.rnn import _aligned, _cdiv

CHUNK = 32  # sorted positions a warp of the chunk kernel sums (kChunk)
MERGE_WARPS = 8  # groups a crossing run's partials are summed in (kMergeWarps)

# Launches of the CUDA wrapper: one a call, each running the chunk and the
# merge kernel once.
launches = {"embed_grad": 0}


def table_grad_reference(tokens: torch.Tensor, dy: torch.Tensor, vocab: int) -> torch.Tensor:
    """The kernel's sums in the kernel's order, float32, in plain PyTorch.

    The ids are sorted stably and cut into chunks of ``CHUNK`` sorted
    positions. In a chunk, each run of one id is summed in sorted order
    from 0; a run inside the chunk is its row's gradient; a run that
    crosses the chunk's left or right edge is the chunk's partial (slot 0
    its first run, slot 1 its last). A crossing run's row is the sum of its
    partials in chunk order, cut into ``MERGE_WARPS`` contiguous groups,
    each summed from 0, the groups' sums added from 0 in group order."""
    E = dy.shape[-1]
    tok = tokens.reshape(-1).long().remainder(vocab)
    dy2 = dy.reshape(-1, E).float()
    N = tok.numel()
    dt = torch.zeros((vocab, E), dtype=torch.float32, device=dy.device)
    if N == 0:
        return dt
    ids, order = torch.sort(tok, stable=True)
    C = _cdiv(N, CHUNK)
    pad = C * CHUNK - N
    rows = torch.cat([dy2[order], dy2.new_zeros((pad, E))]).view(C, CHUNK, E)
    idc = torch.cat([ids, ids.new_full((pad,), -1)]).view(C, CHUNK)
    fresh = torch.ones((C, CHUNK), dtype=torch.bool, device=ids.device)
    fresh[:, 1:] = idc[:, 1:] != idc[:, :-1]
    sums = torch.empty((C, CHUNK, E), dtype=torch.float32, device=dy.device)
    acc = torch.zeros((C, E), dtype=torch.float32, device=dy.device)
    for j in range(CHUNK):  # every chunk's j-th position at once
        acc = torch.where(fresh[:, j, None], torch.zeros_like(acc), acc) + rows[:, j]
        sums[:, j] = acc
    sums = sums.view(C * CHUNK, E)[:N]

    pos = torch.arange(N, device=ids.device)
    lo = pos - pos % CHUNK
    after = torch.cat([ids[1:], ids.new_full((1,), -1)])
    ends = ids != after  # the run ends here
    last = (pos % CHUNK == CHUNK - 1) | (pos == N - 1)
    first_run = ids == ids[lo]  # the chunk's first run
    open_left = (lo > 0) & (ids[(lo - 1).clamp(min=0)] == ids[lo])
    inside = ends & ~(first_run & open_left)
    dt[ids[inside]] = sums[inside]
    part = torch.zeros((C, 2, E), dtype=torch.float32, device=dy.device)
    slot0 = (ends & first_run & open_left) | (~ends & last & first_run)
    slot1 = ~ends & last & ~first_run
    part[pos[slot0] // CHUNK, 0] = sums[slot0]
    part[pos[slot1] // CHUNK, 1] = sums[slot1]

    # the merge: chunk c (not the last) starts a crossing run x where x
    # holds its last position and the next chunk's first, and the run did
    # not begin in an earlier chunk
    his = torch.arange(1, C, device=ids.device) * CHUNK
    x_of, los = ids[his - 1], his - CHUNK
    whole_of = ids[los] == x_of  # the run fills the chunk
    began = whole_of & (los > 0) & (ids[(los - 1).clamp(min=0)] == x_of)
    starts = torch.nonzero((ids[his] == x_of) & ~began).flatten()
    # m: the chunks after c whose first position holds x
    ms = torch.searchsorted(ids[::CHUNK].contiguous(), x_of[starts], right=True) - (starts + 1)
    for c, x, whole, m in zip(starts.tolist(), x_of[starts].tolist(),
                              whole_of[starts].tolist(), ms.tolist()):
        parts = [part[c, 0 if whole else 1]] + [part[c + i, 0] for i in range(1, m + 1)]
        n, total = m + 1, torch.zeros(E, dtype=torch.float32, device=dy.device)
        for w in range(MERGE_WARPS):
            s = torch.zeros(E, dtype=torch.float32, device=dy.device)
            for p in parts[n * w // MERGE_WARPS : n * (w + 1) // MERGE_WARPS]:
                s = s + p
            total = total + s
        dt[x] = total
    return dt


def table_grad(tokens: torch.Tensor, dy: torch.Tensor, vocab: int) -> torch.Tensor:
    """``table[tokens]``'s table cotangent [vocab, E] float32 from the
    cotangent ``dy`` [*tokens.shape, E] float32: ``csrc/embed_grad.cu`` on
    CUDA tensors (capture-safe: nothing syncs, every buffer sized from the
    shapes), ``table_grad_reference`` on CPU tensors. Ids are taken modulo
    ``vocab``, as the lookup takes a negative one."""
    if not dy.is_cuda:
        return table_grad_reference(tokens, dy, vocab)
    E = dy.shape[-1]
    if dy.dtype != torch.float32 or tokens.device != dy.device:
        raise ValueError(f"embed_grad: dy must be float32 on the tokens' device, got {dy.dtype} "
                         f"on {dy.device} (tokens on {tokens.device})")
    tok = tokens.reshape(-1)
    N = tok.numel()
    if tuple(dy.shape) != (*tokens.shape, E) or N >= 2**31 or vocab >= 2**31:
        raise ValueError(f"embed_grad: dy {tuple(dy.shape)} for tokens {tuple(tokens.shape)}, "
                         f"vocab {vocab}")
    dy2 = _aligned(dy.reshape(N, E))
    ids, order = torch.sort(tok.remainder(vocab).to(torch.int32), stable=True)
    dt = torch.empty((vocab, E), dtype=torch.float32, device=dy.device)
    part = torch.empty((_cdiv(N, CHUNK), 2, E), dtype=torch.float32, device=dy.device)
    _build.launch(
        "sse_embed_grad", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3, dy.device,
        ids.data_ptr(), order.data_ptr(), dy2.data_ptr(), dt.data_ptr(), part.data_ptr(),
        N, E, vocab,
    )
    launches["embed_grad"] += 1
    return dt
