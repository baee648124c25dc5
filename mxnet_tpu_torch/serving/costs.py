"""The decode session's cost arithmetic (reference: the prefill-chunk cap of
mxnet_tpu/costmodel.py ``prefill_chunk_cap`` and
mxnet_tpu/perfmodel/__init__.py ``prefill_chunk_cap``/``eviction_score``,
without a learned artifact).

The reference probes XLA's cost analysis of the bound one-token and chunked
programs. The port has none, so the two costs are operation counts over the
bound executors' shapes (:func:`forward_flops`): the FullyConnected GEMMs
and the decode attention's projections and score/value products.
"""
from __future__ import annotations

__all__ = ["prefill_chunk_cap", "eviction_score", "forward_flops"]


def prefill_chunk_cap(requested, cost_at_1, cost_at_k, stall_factor=8.0):
    """The largest ``K' <= requested`` whose estimated chunked-step cost
    stays within ``stall_factor`` x a single-token step, by linear
    interpolation between the two probes (``cost(K) ~= fixed + per_tok *
    K``). Degenerate probes (zero, missing, or not increasing) leave
    ``requested`` uncapped."""
    requested = int(requested)
    if requested <= 1:
        return requested
    c1 = float(cost_at_1 or 0.0)
    ck = float(cost_at_k or 0.0)
    if c1 <= 0.0 or ck <= c1:
        return requested
    budget = stall_factor * c1
    if ck <= budget:
        return requested
    per_tok = (ck - c1) / (requested - 1)
    cap = 1 + int((budget - c1) / per_tok)
    return max(1, min(requested, cap))


def eviction_score(nbytes, idle_s, half_life_s=30.0):
    """Victim score of a cached entry: its bytes times the chance it is
    asked for again (halving every ``half_life_s`` idle seconds). The
    least score goes first."""
    if half_life_s <= 0:
        return float(nbytes)
    return float(nbytes) * 2.0 ** (-float(idle_s) / float(half_life_s))


def _node_flops(node, ins):
    """Operations of one node on inputs of these shapes: 2 a
    multiply-add of the FullyConnected GEMM, the decode attention's four
    projections and its score and value products over the cache length."""
    if node.op == "FullyConnected":
        data, weight = ins[0], ins[1]
        return 2.0 * data.numel() * weight.shape[0]
    if node.op in ("DecodeAttention", "BatchDecodeAttention"):
        b, k, e = ins[0].shape
        if int(node.attrs.get("paged", 0)):
            t = int(node.attrs["max_len"])
        else:
            t = ins[5].shape[1]
        return 8.0 * b * k * e * e + 4.0 * b * k * t * e
    return 0.0


def forward_flops(executor):
    """Operations of one forward of a bound executor at its bound shapes:
    the graph walked on ``meta`` tensors (shapes, no data), each node
    counted by :func:`_node_flops`."""
    import torch

    from ..ops import OpCtx, get_op

    ctx = OpCtx(device=torch.device("meta"))
    vals, flops = {}, 0.0
    for node in executor._symbol._nodes():
        if node.is_variable:
            arr = executor.arg_dict.get(node.name)
            if arr is None:
                arr = executor.aux_dict[node.name]
            vals[(id(node), 0)] = torch.empty(arr.shape, dtype=arr.dtype,
                                              device="meta")
            continue
        ins = [vals[(id(n), i)] for n, i in node.inputs]
        aux = [vals[(id(a), 0)] for a in node.aux_vars]
        flops += _node_flops(node, ins)
        outs, _ = get_op(node.op).normalized_call(ctx, node.attrs, ins, aux)
        for i, o in enumerate(outs):
            vals[(id(node), i)] = o
    return flops
