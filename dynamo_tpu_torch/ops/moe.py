"""Sparse Mixture-of-Experts block (port of ``dynamo_tpu/ops/moe.py``).

The reference's GShard-style capacity dispatch: each expert has ``capacity =
ceil(T * K * capacity_factor / E)`` slots; routing slots fill them in
slot-major, token-minor order (all tokens' first choices, then all second
choices, ...), and a (token, slot) pair past its expert's capacity is
dropped (its weight goes nowhere). The port takes the same order and the
same drop rule, so it drops the same pairs token for token, and runs every
expert on its ``capacity`` slots as one batched product, exactly as the
reference's einsums do.

Where the reference builds one-hot ``[T, K, E, C]`` dispatch/combine
tensors, the port scatters each kept pair's hidden row into its slot and
gathers the slot's output back: the same function without the one-hot
memory. Every index is computed on the device, with no data-dependent
shape, so nothing here waits for the host. Int8 expert banks are not ported
yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def topk_routing(
    router_logits: torch.Tensor,  # [T, E] float32
    k: int,
    renormalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights [T, K], indices [T, K]).

    renormalize=True (Mixtral, norm_topk_prob): softmax over the selected k.
    renormalize=False (DeepSeek default): softmax over ALL experts, top-k
    probabilities used as-is."""
    top_logits, top_idx = torch.topk(router_logits, k, dim=-1)
    if renormalize:
        weights = torch.softmax(top_logits, dim=-1)
    else:
        weights = torch.gather(torch.softmax(router_logits, dim=-1), -1, top_idx)
    return weights, top_idx


def moe_block(
    hidden: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
    num_experts_per_tok: int,
    capacity_factor: float = 2.0,
    renormalize: bool = True,
) -> torch.Tensor:
    T, D = hidden.shape
    E = router_w.shape[1]
    K = num_experts_per_tok
    capacity = max(1, int(-(-T * K * capacity_factor // E)))

    logits = hidden.float() @ router_w.float()  # [T, E]
    weights, idx = topk_routing(logits, K, renormalize=renormalize)  # [T, K]

    # routing slots flattened slot-major (row k*T + t), the reference's
    # cumsum order; pos = the pair's place in its expert's queue. The count
    # runs along the innermost axis of [E, K*T]: on an H100 the outer-axis
    # scan of [K*T, E] took 519 of the 2917 ms of prefill device time of the
    # V2-Lite serve workload (tools/profile_serve.py)
    flat_idx = idx.t().reshape(K * T)
    chose = torch.arange(E, device=hidden.device)[:, None] == flat_idx[None, :]  # [E, K*T]
    pos = chose.cumsum(1, dtype=torch.int32).gather(0, flat_idx[None])[0] - 1
    keep = pos < capacity
    # kept pairs own slot e*C + pos; dropped pairs write the extra row E*C,
    # which no expert reads
    slot = torch.where(keep, flat_idx * capacity + pos, E * capacity)
    tok = torch.arange(T, device=hidden.device).repeat(K)
    expert_in = hidden.new_zeros((E * capacity + 1, D))
    expert_in.index_put_((slot,), hidden[tok])
    expert_in = expert_in[: E * capacity].view(E, capacity, D)

    # batched expert FFN: [E, C, D] x [E, D, F]
    gated = F.silu(torch.bmm(expert_in, w_gate))
    expert_out = torch.bmm(gated * torch.bmm(expert_in, w_up), w_down).view(E * capacity, D)

    # combine: each token's K slot outputs, weighted (dropped pairs weigh 0)
    w_flat = torch.where(keep, weights.t().reshape(K * T), 0.0)
    picked = expert_out[torch.where(keep, slot, 0)].float() * w_flat[:, None]
    return picked.view(K, T, D).sum(0).to(hidden.dtype)
