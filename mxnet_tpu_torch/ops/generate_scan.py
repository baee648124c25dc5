"""Whole-sequence autoregressive generation as one op (reference:
mxnet_tpu/ops/generate_scan.py).

The reference runs the greedy loop as one XLA program: a scan over time
steps, a scan over layer-stacked weights (the TransformerStack convention)
inside it, per-layer KV caches carried through, argmax sampling on the
device. Here one token step is a function over tensors that hold the whole
state on the device (the current token, the position ``t``, the caches and
the output), written in place. On the CPU it runs eagerly once a token. On
the card it is captured as one CUDA graph (after an eager warm-up on a side
stream) and the graph is replayed once a token: nothing syncs with the host
before the caller reads the result. A graph is kept for each set of weight
tensors, shapes and sampling settings (:data:`_SCANS`, the last
:data:`_KEEP`), so a later call with the same arrays replays at once.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..base import MXNetError
from ..storage import no_collection
from .attention import cached_attention_core
from .registry import register_op
from .tensor import as_int32, op_rng
from .transformer_stack import _ROLES, _layer_norm

_INPUTS = ("prime", "embed_weight", "pos_weight") + \
    tuple(name for name, _ in _ROLES) + \
    ("final_gamma", "final_beta", "head_weight", "head_bias")

_KEEP = 4
_SCANS: OrderedDict = OrderedDict()
# captures and replays of the token-step graphs since import (the card only)
stats = {"captures": 0, "replays": 0}


def _require_num_layers(attrs):
    if "num_layers" not in attrs:
        raise MXNetError("GenerateScan requires attr num_layers (the "
                         "stacked-block leading dimension)")
    return attrs["num_layers"]


def _gen_infer(attrs, shapes):
    e_shape = shapes.get("embed_weight")
    if e_shape is not None:
        e = e_shape[1]
        n_layers = int(_require_num_layers(attrs))
        hid = int(attrs.get("ffn_hidden", 4 * e))
        for name, shape_fn in _ROLES:
            shapes.setdefault(name, (n_layers,) + shape_fn(e, hid))
        shapes.setdefault("final_gamma", (e,))
        shapes.setdefault("final_beta", (e,))
    return shapes


class _Scan:
    """One generation's state on the device and its token step. ``step``
    feeds ``cur`` at position ``t`` through every layer, writes the KV rows
    at ``t``, picks the next token (argmax, or a Gumbel-max draw from
    ``gen`` at ``temperature``; the prime's token while ``t + 1 < P``),
    writes it to ``out[:, t + 1]`` and advances ``cur`` and ``t``."""

    def __init__(self, weights, b, p, total, heads, temperature, gen):
        embed_w = weights[0]
        n_layers = weights[2].shape[0]
        e = embed_w.shape[1]
        dev = embed_w.device
        self.weights = weights
        self.heads = heads
        self.temperature = temperature
        self.gen = gen
        self.total = total
        self.prime = torch.zeros((b, p), dtype=torch.int64, device=dev)
        self.cache_k = torch.zeros((n_layers, b, total, e),
                                   dtype=embed_w.dtype, device=dev)
        self.cache_v = torch.zeros_like(self.cache_k)
        self.cur = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((b, total), dtype=torch.int64, device=dev)
        self.graph = None
        self.stream = None

    def reset(self, prime):
        self.prime.copy_(prime)
        self.cache_k.zero_()
        self.cache_v.zero_()
        self.cur.copy_(self.prime[:, 0])
        self.t.zero_()
        self.out.zero_()
        self.out[:, :1].copy_(self.prime[:, :1])

    def step(self):
        embed_w, pos_w = self.weights[:2]
        n_roles = len(_ROLES)
        stacked = self.weights[2:2 + n_roles]
        final_g, final_b, head_w, head_b = self.weights[2 + n_roles:]
        b, p = self.prime.shape
        t = self.t.reshape(1)
        h = embed_w.index_select(0, self.cur)[:, None, :] \
            + pos_w.index_select(0, t)[None]                     # (B,1,E)
        for i in range(stacked[0].shape[0]):
            (g1, b1, wq, wk, wv, wo, g2, b2, w1, bb1, w2, bb2) = \
                (w[i] for w in stacked)
            hn = _layer_norm(h, g1, b1)
            att, _, _ = cached_attention_core(
                hn, wq, wk, wv, wo, self.cache_k[i], self.cache_v[i],
                self.t, self.heads)
            x = h + att
            ff = torch.relu(_layer_norm(x, g2, b2) @ w1.T + bb1)
            h = x + ff @ w2.T + bb2
        h = _layer_norm(h, final_g, final_b)
        logits = h[:, 0, :] @ head_w.T + head_b                   # (B,V)
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=self.gen,
                           device=logits.device)
            nxt = torch.argmax(logits.float() / self.temperature
                               - torch.log(-torch.log(u)), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nt = t + 1
        from_prime = self.prime.index_select(1, nt.clamp(max=p - 1))
        cur_next = torch.where(nt < p, from_prime.reshape(b), nxt)
        self.out.index_copy_(1, nt, cur_next.reshape(b, 1))
        self.cur.copy_(cur_next)
        self.t.add_(1)

    def run(self, prime):
        """All ``total - 1`` token steps from ``prime``; the (B, total)
        int64 tokens (a new tensor)."""
        if self.prime.device.type != "cuda":
            self.reset(prime)
            for _ in range(self.total - 1):
                self.step()
            return self.out.clone()
        main = torch.cuda.current_stream(self.prime.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.prime.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            if self.graph is None:
                self.reset(prime)
                self.step()       # the warm-up: cuBLAS sets itself up
                graph = torch.cuda.CUDAGraph()
                if self.gen is not None:
                    graph.register_generator_state(self.gen)
                with no_collection(), \
                        torch.cuda.graph(graph, stream=self.stream,
                                         capture_error_mode="thread_local"):
                    self.step()
                self.graph = graph
                stats["captures"] += 1
            self.reset(prime)
            for _ in range(self.total - 1):
                self.graph.replay()
            stats["replays"] += self.total - 1
        main.wait_stream(self.stream)
        return self.out.clone()


def _scan_for(weights, b, p, total, heads, temperature, gen):
    key = (tuple(id(w) for w in weights), b, p, total, heads, temperature,
           None if gen is None else id(gen))
    scan = _SCANS.pop(key, None)
    if scan is None:
        scan = _Scan(weights, b, p, total, heads, temperature, gen)
    _SCANS[key] = scan
    while len(_SCANS) > _KEEP:
        _SCANS.popitem(last=False)
    return scan


@register_op("GenerateScan", inputs=_INPUTS, infer_param_shapes=_gen_infer,
             attr_defaults={"num_heads": 1, "gen_len": 1,
                            "temperature": 0.0})
def _generate_scan(ctx, attrs, prime, embed_w, pos_w, *rest):
    """prime (B, P) token ids -> (B, P + gen_len) tokens, in the prime's
    dtype. attrs: num_layers, num_heads, gen_len, temperature. P + gen_len
    must fit pos_weight's first dim (the trained context window).
    temperature 0 (the default) is greedy argmax; above 0 each token is
    drawn from softmax(logits / temperature) with the node's generator."""
    heads = int(attrs.get("num_heads", 1))
    gen_len = int(attrs.get("gen_len", 1))
    temperature = float(attrs.get("temperature", 0.0))
    int(_require_num_layers(attrs))
    b, p = prime.shape
    e = embed_w.shape[1]
    total = p + gen_len
    if e % heads != 0:
        raise MXNetError(f"GenerateScan: hidden {e} not divisible by "
                         f"num_heads {heads}")
    if total > pos_w.shape[0]:
        raise MXNetError(
            f"GenerateScan: prime {p} + gen_len {gen_len} exceeds the "
            f"position table ({pos_w.shape[0]}) — the trained context "
            "window bounds generation")
    if prime.device.type == "meta":
        return torch.empty((b, total), dtype=prime.dtype, device="meta")
    gen = op_rng(ctx, prime.device) if temperature > 0 else None
    weights = (embed_w, pos_w) + tuple(rest)
    with torch.no_grad():
        scan = _scan_for(weights, b, p, total, heads, temperature, gen)
        out = scan.run(as_int32(prime).to(torch.int64))
    return out.to(prime.dtype)
