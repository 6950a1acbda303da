"""The exact DAM retrieval tie that the port's Flash memory tests accept
where two implementations retrieve different frames for one slot."""
import torch

from flash_vstream_tpu_torch.ops.retrieval import topk_by_weight


def dam_tie(state, t_dam, j, p_a, p_b, rtol):
    """Whether DAM slot j's query cluster (the heaviest valid clusters of
    the FlashState `state`) is as near to bank frame p_a as to p_b, within
    `rtol` of the larger distance: a merged slot or a two-frame cluster of
    equal weights sits midway between its frames, and rounding picks the
    side."""
    w = torch.where(state.tem_valid, state.tem_weights, float("-inf"))
    q = state.tem_x[topk_by_weight(w, t_dam)[j]].float().flatten()

    def dist(p):
        slot = int((state.bank_pos == p).nonzero()[0, 0])
        return ((state.bank_small[slot].float().flatten() - q) ** 2).sum().item()

    return abs(dist(p_a) - dist(p_b)) <= rtol * max(dist(p_a), dist(p_b))
