"""CTC forced-alignment trellis: a Viterbi loop over time in PyTorch.

Port of :mod:`tiny_audio_tpu.ops.ctc`: each time step is one vectorized
update over every token position (the JAX package's ``lax.scan`` body), on
the emission's device; the backtrack runs on the host over the recorded
move decisions.

    trellis[t+1, j] = max(trellis[t, j]   + emission[t, blank],       # stay
                          trellis[t, j-1] + emission[t, tokens[j-1]]) # move

with trellis[0, 0] = 0 and everything else -1e30; ties prefer the move.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


@torch.inference_mode()
def ctc_trellis(emission: torch.Tensor, tokens: torch.Tensor, blank_id: int = 0):
    """Viterbi trellis + move decisions.

    Args:
        emission: [T, C] log-probabilities.
        tokens: [N] target token ids.

    Returns:
        (trellis [T+1, N+1] float32, moved [T, N+1] bool), on the emission's
        device, where ``moved[t, j]`` records whether the best path into
        (t+1, j) consumed token j-1 at frame t.
    """
    emission = emission.to(torch.float32)
    device = emission.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
    n_tokens = tokens.shape[0]
    t_frames = emission.shape[0]
    init = torch.full((n_tokens + 1,), NEG_INF, dtype=torch.float32, device=device)
    init[0] = 0.0
    trellis = torch.empty((t_frames + 1, n_tokens + 1), dtype=torch.float32, device=device)
    trellis[0] = init
    moved = torch.empty((t_frames, n_tokens + 1), dtype=torch.bool, device=device)
    stay_scores = emission[:, blank_id]
    token_scores = emission[:, tokens]  # [T, N]
    never = torch.full((1,), NEG_INF, dtype=torch.float32, device=device)  # nothing before j = 0
    for t in range(t_frames):
        prev = trellis[t]
        stay = prev + stay_scores[t]
        move = torch.cat([never, prev[:-1] + token_scores[t]])
        moved[t] = move >= stay  # ties prefer move
        trellis[t + 1] = torch.maximum(stay, move)
    return trellis, moved


def ctc_backtrack(
    trellis: np.ndarray,
    moved: np.ndarray,
    tokens: np.ndarray,
) -> list[tuple[int, float, float]]:
    """Backtrack move decisions into per-token (token_id, start_f, end_f) spans.

    Monotonic, every token emitted exactly once; uniform fallback when the
    trellis never reached the final state.
    """
    t_frames = trellis.shape[0] - 1
    n_tokens = len(tokens)
    if n_tokens == 0:
        return []

    if trellis[t_frames, n_tokens] <= NEG_INF / 2:
        per = t_frames / n_tokens
        return [(int(tokens[i]), i * per, (i + 1) * per) for i in range(n_tokens)]

    # A reachable (T, N) final state always consumes every token on the way
    # back to t=0 (each backtrack step either moves j down or t down, and
    # the reachability check above guarantees a full path exists), so every
    # token_frames[j] is non-empty here.
    token_frames: list[list[int]] = [[] for _ in range(n_tokens)]
    t, j = t_frames, n_tokens
    while t > 0 and j > 0:
        if moved[t - 1, j]:
            token_frames[j - 1].append(t - 1)
            j -= 1
        t -= 1

    spans: list[tuple[int, float, float]] = []
    for idx, frames in enumerate(token_frames):
        if not frames:
            # Unreachable for a (trellis, moved) pair from the same forward
            # pass (see invariant above); a mismatched pair from different
            # runs should fail loudly, not with a bare min() ValueError.
            raise ValueError(
                f"ctc_backtrack: token {idx} got no frames — trellis/moved "
                "matrices are inconsistent (were they produced together?)"
            )
        start = float(min(frames))
        end = float(max(frames)) + 1.0
        spans.append((int(tokens[idx]), start, end))
    return spans
