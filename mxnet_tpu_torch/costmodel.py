"""Cost-model-guided batch bucketing and the serving cost arithmetic
(reference: mxnet_tpu/costmodel.py).

The dynamic batcher pads coalesced requests up to a fixed set of batch-dim
buckets, so the set of bound executors stays bounded. Powers of two ignore
the traffic: a replica whose requests are almost all 3 rows pays a third of
its compute for padding (3 -> bucket 4). :func:`choose_buckets` picks the
boundaries from the observed request-rows histogram instead, minimizing the
expected padded cost under a per-bucket step-cost model
(:class:`LinearCostModel`); its candidate set always holds the power-of-two
ladder, so ``auto`` buckets are never worse than ``pow2`` on the histogram
they were fit to. Bucket choice moves only padding boundaries: outputs are
the same for every bucket set (padding rows are zeros and are sliced off).

The reference fits the cost model from XLA's cost analysis of the lowered
forward. The port has none: its costs are operation counts over a bound
executor's shapes (:func:`forward_flops`), the graph walked on ``meta``
tensors: the FullyConnected and Convolution products and the decode
attention's projections and score/value products. The same counts size the
decode session's prefill chunk (:func:`prefill_chunk_cap`).
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["LinearCostModel", "forward_cost", "executor_forward_cost",
           "forward_flops", "fit_cost_model", "prefill_chunk_cap",
           "choose_buckets", "expected_waste"]


def _pow2_ladder(max_batch_size):
    """Power-of-two sizes up to max_batch_size inclusive (the batcher's
    ``pow2_buckets``, without importing serving)."""
    if max_batch_size < 1:
        raise MXNetError(
            f"max_batch_size must be >= 1, got {max_batch_size}")
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return out


class LinearCostModel:
    """``cost(rows) = fixed + per_row * rows``: the per-bucket step-cost
    model the bucket chooser minimizes against. ``per_row=1, fixed=0``
    (the default where no model is at hand) makes expected waste exactly
    the expected padded rows."""

    def __init__(self, per_row=1.0, fixed=0.0, unit="rows", detail=None):
        self.per_row = float(per_row)
        self.fixed = float(fixed)
        self.unit = unit
        self.detail = detail or {}

    def cost(self, rows):
        return self.fixed + self.per_row * float(rows)

    @classmethod
    def fit(cls, points, unit="cost", detail=None):
        """Least-squares line through ``[(rows, cost), ...]``. One point
        fits through the origin; a negative slope or intercept is clamped
        to zero (cost must be monotone in rows)."""
        pts = [(float(r), float(c)) for r, c in points]
        if not pts:
            raise MXNetError("LinearCostModel.fit: no points")
        if len(pts) == 1:
            r, c = pts[0]
            return cls(per_row=c / r if r else 0.0, fixed=0.0, unit=unit,
                       detail=detail)
        n = len(pts)
        sx = sum(r for r, _ in pts)
        sy = sum(c for _, c in pts)
        sxx = sum(r * r for r, _ in pts)
        sxy = sum(r * c for r, c in pts)
        denom = n * sxx - sx * sx
        if denom == 0:  # all probes at one batch size
            return cls.fit(pts[:1], unit=unit, detail=detail)
        per_row = (n * sxy - sx * sy) / denom
        fixed = (sy - per_row * sx) / n
        return cls(per_row=max(per_row, 0.0), fixed=max(fixed, 0.0),
                   unit=unit, detail=detail)

    def __repr__(self):
        return (f"LinearCostModel(per_row={self.per_row:g}, "
                f"fixed={self.fixed:g}, unit={self.unit!r})")


def _node_flops(node, ins, outs):
    """Operations of one node on inputs of these shapes (2 a multiply-add):
    the FullyConnected GEMM, the Convolution's products, the decode
    attention's four projections and its score and value products over the
    cache length."""
    if node.op == "FullyConnected":
        data, weight = ins[0], ins[1]
        return 2.0 * data.numel() * weight.shape[0]
    if node.op == "Convolution":
        weight = ins[1]
        return 2.0 * outs[0].numel() * (weight.numel() // weight.shape[0])
    if node.op in ("DecodeAttention", "BatchDecodeAttention"):
        b, k, e = ins[0].shape
        if int(node.attrs.get("paged", 0)):
            t = int(node.attrs["max_len"])
        else:
            t = ins[5].shape[1]
        return 8.0 * b * k * e * e + 4.0 * b * k * t * e
    return 0.0


def _forward_counts(executor):
    """(operations, bytes each node reads and writes) of one forward of a
    bound executor at its bound shapes, the graph walked on ``meta``
    tensors (shapes, no data)."""
    import torch

    from .ops import OpCtx, get_op

    ctx = OpCtx(device=torch.device("meta"))
    vals, flops, nbytes = {}, 0.0, 0.0
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
        outs, _ = get_op(node.op).normalized_call(ctx, node.attrs, ins, aux)
        flops += _node_flops(node, ins, outs)
        nbytes += sum(t.numel() * t.element_size() for t in ins + list(outs))
        for i, o in enumerate(outs):
            vals[(id(node), i)] = o
    return flops, nbytes


def forward_flops(executor):
    """Operations of one forward of a bound executor at its bound shapes
    (each node counted by :func:`_node_flops`)."""
    return _forward_counts(executor)[0]


def executor_forward_cost(executor):
    """``{"flops", "bytes_accessed"}`` of one forward of a bound executor at
    its bound shapes (the port's stand-in for XLA's cost analysis; bytes:
    every node's inputs read and outputs written once)."""
    flops, nbytes = _forward_counts(executor)
    return {"flops": flops, "bytes_accessed": nbytes}


def forward_cost(predictor, input_shapes):
    """:func:`executor_forward_cost` of one inference forward at exactly
    ``input_shapes`` (a binding of ``predictor``'s, then dropped)."""
    ex, _ = predictor.bind_forward(input_shapes)
    return executor_forward_cost(ex)


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


def fit_cost_model(predictor=None, max_batch_size=None, template=None,
                   probe_sizes=None, points=None, unit="seconds"):
    """A :class:`LinearCostModel` of a predictor's forward, from operation
    counts at a small and a large batch (:func:`forward_cost`), or from
    ``points``, recorded ``(rows, cost)`` measurements alone (``unit``
    labels what ``cost`` measures there). ``template`` maps each input to
    its per-row dims (default: the predictor's bind template without its
    batch dim). Uses operations, else bytes, else the padded-rows unit
    model (an estimate that fails must not take down a server)."""
    if points is not None:
        pts = [(float(r), float(c)) for r, c in points]
        if not pts:
            raise MXNetError("fit_cost_model: empty points")
        return LinearCostModel.fit(
            pts, unit=unit, detail={"source": "recorded", "n": len(pts)})
    if predictor is None or max_batch_size is None:
        raise MXNetError(
            "fit_cost_model: pass (predictor, max_batch_size) for the probe "
            "path, or points=[(rows, cost), ...] for the recorded-corpus "
            "path")
    if template is None:
        template = {name: tuple(shape)[1:]
                    for name, shape in predictor._input_shapes.items()}
    if probe_sizes is None:
        probe_sizes = (1, int(max_batch_size))
    probe_sizes = sorted({max(1, int(b)) for b in probe_sizes})
    probes = {}
    try:
        for b in probe_sizes:
            probes[b] = forward_cost(
                predictor, {n: (b,) + tuple(f) for n, f in template.items()})
    except Exception:
        return LinearCostModel(detail={"fallback": "padded_rows"})
    for metric in ("flops", "bytes_accessed"):
        points = [(b, c[metric]) for b, c in probes.items() if c[metric] > 0]
        if points:
            return LinearCostModel.fit(
                points, unit=metric,
                detail={"probes": {b: dict(c) for b, c in probes.items()},
                        "metric": metric})
    return LinearCostModel(detail={"fallback": "padded_rows",
                                   "probes": probes})


def _normalize_histogram(histogram, max_batch_size):
    """{rows: weight} with rows clamped into [1, max_batch_size] (oversize
    requests are chunked at the top bucket, so that is the cost they pay)."""
    hist = {}
    for n, w in (histogram or {}).items():
        n, w = int(n), float(w)
        if n < 1 or w <= 0:
            continue
        n = min(n, int(max_batch_size))
        hist[n] = hist.get(n, 0.0) + w
    return hist


def choose_buckets(histogram, max_batch_size, cost_model=None,
                   max_buckets=None, per_bucket_cost=0.0):
    """Bucket boundaries minimizing expected per-request step cost over a
    batch-size histogram, plus ``per_bucket_cost`` per boundary (the
    amortization term: each bucket is one binding and one capture a cold
    replica must pay; raise it to trade a little padding for fewer
    cold-start captures).

    Exact dynamic program over the candidate boundary set = observed sizes
    ∪ the pow2 ladder ∪ {max_batch_size} (so at ``per_bucket_cost=0`` the
    result is provably never worse than ``pow2`` on this histogram), at
    most ``max_buckets`` boundaries (default: the pow2 ladder length,
    keeping the capture count no worse than the default ladder). The top
    boundary is always ``max_batch_size`` so any admissible request still
    fits a bucket. Boundaries that cover no observed traffic are dropped
    (minimal set for the same expected cost).
    """
    max_batch_size = int(max_batch_size)
    hist = _normalize_histogram(histogram, max_batch_size)
    if not hist:
        raise MXNetError("choose_buckets: empty batch-size histogram "
                         "(use the pow2 ladder until traffic is observed)")
    if cost_model is None:
        cost_model = LinearCostModel()
    ladder = _pow2_ladder(max_batch_size)
    cand = sorted(set(hist) | set(ladder) | {max_batch_size})
    m = len(cand)
    limit = min(max_buckets or len(ladder), m)
    if limit < 1:
        raise MXNetError(f"choose_buckets: max_buckets={max_buckets}")
    cost = [cost_model.cost(c) for c in cand]
    # prefix[j] = total weight of observed sizes <= cand[j]
    prefix, acc = [], 0.0
    for c in cand:
        acc += hist.get(c, 0.0)
        prefix.append(acc)
    INF = float("inf")
    # best[k][j]: min expected cost covering sizes <= cand[j] with k
    # boundaries, the largest being cand[j]; parent for reconstruction
    best = [[INF] * m for _ in range(limit + 1)]
    parent = [[-1] * m for _ in range(limit + 1)]
    for j in range(m):
        best[1][j] = cost[j] * prefix[j]
    for k in range(2, limit + 1):
        for j in range(k - 1, m):
            for i in range(j):
                prev = best[k - 1][i]
                if prev == INF:
                    continue
                c = prev + cost[j] * (prefix[j] - prefix[i])
                if c < best[k][j]:
                    best[k][j] = c
                    parent[k][j] = i
    last = m - 1  # cand[last] == max_batch_size: the forced top boundary
    k_best = min(range(1, limit + 1),
                 key=lambda k: best[k][last] + k * float(per_bucket_cost))
    buckets, j, k = [], last, k_best
    while j >= 0 and k >= 1:
        buckets.append(cand[j])
        j, k = parent[k][j], k - 1
    buckets = sorted(buckets)
    # drop zero-traffic boundaries the DP kept as ties (never the top)
    kept, covered = [], 0.0
    for b in buckets:
        w = prefix[cand.index(b)]
        if b == max_batch_size or w > covered:
            kept.append(b)
            covered = w
    return kept


def expected_waste(buckets, histogram, max_batch_size=None, cost_model=None):
    """Padded-compute accounting for a bucket set over a histogram:
    ``expected_cost`` (what the buckets pay per the cost model),
    ``ideal_cost`` (unpadded), ``waste`` (their difference — expected
    padded cost per the model; with the default unit model, expected
    padded rows) and ``waste_ratio`` (waste / expected_cost). This is the
    accounting the ``auto``-beats-``pow2`` tests and the server's
    ``expected_padded_waste_ratio`` use."""
    if cost_model is None:
        cost_model = LinearCostModel()
    buckets = sorted(int(b) for b in buckets)
    if not buckets:
        raise MXNetError("expected_waste: empty bucket set")
    top = max_batch_size if max_batch_size is not None else buckets[-1]
    hist = _normalize_histogram(histogram, top)
    expected = ideal = 0.0
    for n in sorted(hist):
        w = hist[n]
        b = next((b for b in buckets if b >= n), buckets[-1])
        expected += w * cost_model.cost(b)
        ideal += w * cost_model.cost(n)
    waste = expected - ideal
    return {"expected_cost": expected, "ideal_cost": ideal, "waste": waste,
            "waste_ratio": (waste / expected) if expected else 0.0}
