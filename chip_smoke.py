"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main paths at the repo's accelerator width (vocab 32768,
hidden 1024, 16 heads, 12 layers, T=2048): transformer-LM inference through
``Predictor`` in fp32, the imperative path, the LM through
``Executor(amp_dtype="bfloat16")``, its training through
``Module(amp="bfloat16")``, ResNet-50 training through ``Module.fit``, and
from a RecordIO file through ``train_imagenet.py``, and the LSTM-PTB
language model through ``BucketingModule`` and ``lstm_bucketing.py``, then
the training paths again with the step captured as a CUDA graph, and the
image-classification family (LeNet, AlexNet, Inception-v3, the zoo's
scoring scripts), and object detection (SSD, Faster R-CNN); holds every
CUDA kernel on those paths against its plain PyTorch version. Every evaluation forward (``Executor.forward(
is_train=False)``) is captured as one CUDA graph a binding and replayed.
Phases, in order; any failed check ends the run with a non-zero exit and no
result line:

1. device: the card's name and power limit; TF32 off for fp32 parity;
   LeNet's first convolution's fp32 weight gradient at batch 8 from cuDNN
   and from the port's Convolution (which takes it off cuDNN with TF32
   off) against float64, the port's held to 1e-5 of max-abs;
2. build: the kernels from ``mxnet_tpu_torch/csrc`` with nvcc (set-up);
3. kernel vs plain: the flash-attention kernels against their plain version
   at the main path's shape, at ragged shapes with ``q_offset``, at head
   dims 128 and 50 (the 4-byte copy path in fp32, the element-wise path of
   the tensor-core kernel in bf16) and 256 (the split over d), in fp32
   (CUDA cores), bf16 and fp16 (tensor cores), timed per call (as in
   earlier slices) and on the device alone, beside the plain version and a
   library attention call, with its share of the bound;
4. the slice: a Predictor bound at data=(2, 2048) on cuda:0 answers 4
   requests through the captured forward (``set_input`` writes in place; a
   warm-up, a capture, replays), each under the profiler, which counts the
   flash kernels the card ran (12 a request; the wrapper counts the
   warm-up's and the capture's calls only); probabilities checked; then
   the requests again, captured and through the eager walk in turns
   (``Executor.eager_forward``), host ms each, and the output copy's ms;
   one more steady request under ``torch.profiler`` splits the device time
   into the flash kernel, the GEMMs and the rest, beside the idle share;
5. card vs CPU: the same weights at depth 2 on cuda:0 (kernel, launched
   once per layer) and on the CPU (plain versions) must agree, in
   probabilities and in log-probabilities;
6. rtc kernel vs plain: the two user kernels compiled through NVRTC
   (``mxnet_tpu_torch/rtc_examples.py``): axpy through ``CudaKernel`` at the
   phase-4 logits shape in fp32 and bf16, at a ragged size and on inputs
   viewed at a 4-byte offset (exact), and SGD-momentum through ``Rtc`` over
   the (32768, 1024) embedding (<= 1e-6), timed beside their plain
   versions and the library call where there is one; and the host's
   microseconds per launch of each front end;
7. the imperative path at full width: ``mx.random`` draws the LM's 220.3 M
   parameters, gradients and momenta on the card; one ``mx.nd.sgd_mom_update``
   and one ``mx.nd.adam_update`` over every parameter; the Rtc SGD-momentum
   kernel over copies, held to the op; a chain of ``mx.nd`` ops on the
   phase-4 log-probabilities, held to the CPU on one row block; and a
   ``CustomOp`` that pushes the axpy kernel, imperatively and in a Symbol
   through ``Executor.forward``. Kernel launches are counted over this run;
   the Rtc pass reports the device's busy time beside the host's;
8. the amp path: the phase-4 weights bound through
   ``Executor(..., amp_dtype="bfloat16")`` with int32 token ids answer 4
   requests of 2 x 2048 tokens through the captured forward, fed through
   ``forward(data=ids)`` (copied into the bound array), counted and timed
   as in phase 4 (12 tensor-core kernels a request, none of the fp32
   kernel), and timed again fed by rebinding (``arr[:] = ids``, a warm-up
   every forward); one more request traced into flash, GEMMs, the amp
   casts and the rest, beside the idle share; then bf16 on the card against bf16 on the CPU at depth 2
   (batch 1, T 512), and int32 ids above 256 fed into a float32-bound
   ``data`` against the same feed bound as int32 (the ids must not round
   in bf16);
9. training: ``Module(amp="bfloat16")`` over the LM with the fused head
   and Adam at lr 1e-4, batch 4 x 2048 int32 tokens, the phase-4 weights
   through ``init_params(arg_params=...)``; five steps of
   forward(is_train=True) / backward() / update() on one repeated batch
   (step 1 apart, the median of steps 2-5 as the steady step, tokens/s),
   12 bf16 flash launches a step, finite gradients, a falling NLL; a sixth
   step traced into the flash forward, the attention backward's recompute,
   the GEMMs, the fused head, the amp casts, the Adam update and the rest,
   beside the idle share and peak memory; one fp32 step at depth 2 (batch
   1, T 512) on the card against the CPU, fused and dense heads (NLL within
   1e-4, each gradient within 1e-3 of its max-abs); and
   ``mxnet_tpu_torch/examples/train_lm.py`` at its defaults (perplexity
   below 3.5 after 800 steps);
10. ResNet-50 through ``Module.fit`` at ``bench.py``'s accelerator config
   (batch 256, 224 px, 1000 classes, bf16 amp, SGD lr 0.1 momentum 0.9 wd
   1e-4, Xavier gaussian magnitude 2): one epoch over 8 random batches
   from ``--seed`` with the accuracy metric (step 1 apart, the median of
   steps 3-8 as the steady step, img/s); every moving statistic finite and
   moved; one more batch traced into convolution forward and backward,
   BatchNorm forward and backward, pooling, ReLU and residual adds, FC and
   SoftmaxOutput, the amp casts, SGD, the feed's and the metric's copies and
   the rest, beside the host's time by part, the idle share and peak
   memory; ``score`` over 2 batches (its forwards captured: a warm-up, a
   capture and replays); one fp32 SGD step at batch 8, 64 px,
   16 classes on the card against the CPU (NLL within 1e-4, gradients 1e-3
   of max-abs, moving statistics and weights 1e-5, or no further from a
   float64 run of the step than twice the CPU), a bf16 evaluation forward
   card vs CPU (phase 8's log-probability limits, or no further from fp32
   than twice the CPU), and ``mxnet_tpu_torch/examples/train_cifar10.py``
   at its defaults (validation accuracy at least 0.9);
11. ResNet-50 from a RecordIO file through
   ``mxnet_tpu_torch/examples/image_classification/train_imagenet.py`` at
   phase 10's config: a ``.rec``/``.idx`` of 3072 photo-like JPEGs (q95,
   1000 classes, shorter edge 256, longer 256-384) packed from ``--seed``;
   ``fit.py``'s ``--test-io`` decode rate with ``preprocess_threads`` 0 and
   P (the cores less two); one epoch (12 batches, random crop and mirror,
   P decode workers) without and with ``MXNET_DEVICE_PREFETCH=1`` (steady
   step, img/s, idle share, the stager's counters, one more step traced
   into phase 10's groups with the host's time by part); one batch's H2D
   from pageable and pinned memory (and through ``cudaHostRegister``); 3
   batches with and without prefetch bit-identical under deterministic
   cuDNN; ``fit`` stopped after batch 4 of 6 and resumed from its
   checkpoint equal to the uninterrupted run (batch 8, 64 px, fp32); which
   route decoded every JPEG; and ``train_imagenet.py`` on 10 class
   prototypes at 40 px (ResNet-20, 8 epochs) reaching validation accuracy
   0.9;
12. LSTM-PTB through ``BucketingModule``: the port's
   ``mxnet_tpu_torch/examples/rnn/lstm_bucketing.py`` at its defaults (2 x
   200 LSTM, embed 200, batch 32, buckets 10-60, SGD lr 0.01 wd 1e-5) for
   one epoch of 2400 synthetic sentences at PTB's vocabulary (10000) from
   ``--seed``, with the unrolled cells and with the fused ``RNN`` op
   (cuDNN): steady step ms and first-use bind ms by bucket, tokens/s (label
   tokens that are not padding) beside padded positions/s, peak memory;
   one more bucket-60 step traced into FC, the cells' elementwise ops or
   cuDNN's RNN, SoftmaxOutput, the embedding and the update, with the
   host's time by part, the kernel launches and the idle share, and the
   time of the whole-output copy the metric no longer makes; one SGD step a
   bucket (5 and 8) of each variant at a small width on the card against
   the CPU (NLL 1e-5, gradients 1e-4 of max-abs, weights 1e-5); the fused
   op against the unrolled cells at bucket 60, hidden 200 (1e-5), its
   cuDNN route against its step loop for each mode and bidirectional
   (outputs and gradients, 1e-5; the tanh mode 3e-5, see
   ``PTB_LIMITS``), cuDNN's forward and backward timed beside the loop;
   per-node Dropout masks at (4096, 1024); and
   ``tests/test_lstm_bucketing.py``'s gate (validation perplexity below 6)
   with both variants;
13. the one-program step: the module's fused step (forward, backward and
   the optimizer's update) captured as one CUDA graph a binding and
   replayed. (a) phase 12's lstm_bucketing.py epoch, unrolled and fused,
   one graph a bucket; (b) ResNet-50 through train_imagenet.py at phase
   11's config with prefetch and ``MXNET_RUN_N_STEPS`` 1 and 4; (c) phase
   9's LM training step, six steps. Per path and bucket: ``captured`` (and
   the rule that refused a capture), steady step ms, tokens/s or img/s,
   one probe step's host issue ms, kernels, kernel busy ms and idle share,
   warm-up and capture ms, peak allocated and reserved memory. The
   kernels' wrappers count Python calls, which a replay does not make: the
   kernels a replay ran come from its profiler trace. Checks: (a) and
   (b)'s captured steps against the step function run eagerly from the
   same start (bit-identical where two eager runs are, else weights within
   1e-5 of each array's max-abs); (a)'s weights within rtol 2e-4, atol
   2e-5 of phase 12's split path, cuDNN's RNN kernels in each fused
   bucket's traced replay, and the gate (< 6) with both variants; (b)'s
   losses within 1e-4 of the split path's and ``run_n_steps(4)``
   bit-identical to four single captured steps (deterministic cuDNN); (c)
   12 bf16 flash kernels traced in each of six steps, a falling NLL (the
   first loss phase 9's, the first five within 1e-4 of them), and each step
   against two eager runs started from the captured run's weights and Adam
   states (gradients kept with ``MXTPU_FUSED_GRADS=1``): the per-token NLL
   and every gradient and state array bit-identical where the two eager
   runs are (else the NLL within 1e-4 and a gradient within one bf16 ulp,
   2^-7, of its max-abs), and the captured update bit-identical to Adam's
   rule run eagerly on the captured step's gradients and rates;
14. the image-classification family: (a) the port's
   ``examples/image_classification/train_mnist.py --network lenet`` at its
   defaults on the reference's synthetic digits, validation accuracy at
   least 0.95; (b) AlexNet (224 px) and Inception-v3 (299 px) through
   ``Module.fit`` at phase 10's config (batch 256, 1000 classes, bf16 amp,
   SGD lr 0.1 momentum 0.9 wd 1e-4, Xavier gaussian magnitude 2), one epoch
   of 8 random batches with the fused step captured: steady step (median
   of steps 3-8), img/s, captures, peak memory, a probe step's idle share,
   then on the same binding the split path: one step traced into
   convolution forward and backward, BatchNorm, LRN, pooling, FC and
   SoftmaxOutput, Dropout, ReLU and Concat, the amp casts, SGD and the
   rest, and split steps timed for the ratio; (c) inference through
   ``benchmark_score.py``'s binding and rate (the difference of two timed
   runs of 12 and 50 forwards): ResNet-50, AlexNet, Inception-BN and
   Inception-v3 at batch 1 and 32 in fp32 (TF32 off) and batch 32 in bf16,
   the captured forward and the eager walk three times each in turns, one
   capture a binding, the captured output bit-identical to the eager one
   (else within 1e-4), the idle share of 10 traced captured forwards and
   the output copy's ms; (d) one fp32 SGD step of each of the nine
   builders at a small input on cuDNN, card against CPU to phase 10's
   limits (the CPU on the card's ReLU masks and max-pool choices,
   Dropout's masks shared), and LRN in bf16 at AlexNet's shapes against an fp32 plain
   version (2e-2 of max-abs); (e) the port's ``score.py`` (accuracy at
   least 0.95) and ``fine_tune.py`` (frozen weights move by exactly 0, the
   new head's accuracy at least 0.9);
15. object detection: (a) SSD through the port's
   ``examples/ssd/evaluate.py`` ``train_and_map`` (8 epochs, batch 32, 256
   synthetic 64 px scenes, Adam 5e-3; the fused step captured once), its
   gates mAP@0.5 >= 0.5 and mAP@0.75 >= 0.2, the loop's steady step, and on
   a batch on the card the captured step (kernels, idle share) against the
   split step (traced by op group, host ms by part); ``train.py`` at its
   defaults (mean IoU, class accuracy); (b) one fp32 Adam step at batch 8
   card vs CPU through phase 10's shared step (TF32 off, cuDNN, the split
   path; the CPU and a float64 step on the card's ReLU masks, max-pool
   choices and MultiBoxTarget outputs): MultiBoxTarget on the CPU on the
   card's inputs gives the card's targets exactly, the CPU's own targets
   equal them but in samples at a mining near-tie, cls_prob and loc_loss
   within 1e-4, gradients 1e-3 and weights 1e-5 of max-abs (or no further
   from float64 than twice the CPU); the detection graph at (a)'s weights:
   MultiBoxDetection's inputs within 1e-4, and the op on the CPU on the
   card's inputs against the card's output as (d) holds it; (c) Faster
   R-CNN through ``examples/rcnn/train_faster_rcnn.py`` ``train_and_eval``
   (10 epochs of 24 steps at batch 4): accuracy >= 0.8 and mean IoU >=
   0.5, the step split into the Custom op's host time and the rest, the
   rule that refused its capture; ``rcnn_toy.py`` to its assertion (>
   0.8); (d) MultiBoxTarget and MultiBoxDetection at SSD-300's 8732
   anchors (21 classes, batch 32), Proposal at its defaults on a 38 x 63
   map (batch 1 and 2) and at the example's shapes, ROIPooling forward and
   gradient at the examples' shapes, each card vs CPU with per-call and
   device ms: MultiBoxTarget's ids, masks and targets exact but in
   samples at a mining near-tie (1e-6); MultiBoxDetection and Proposal on
   the CPU on the card's overlap matrices equal the card's output (ids,
   scores, batch indices exact, boxes 1e-5), and the CPU's own output
   parts from it only in rows that overlaps on opposite sides of the NMS
   threshold decide; ROIPooling's forward exact; and the values
   ROIPooling's masked form would hold at VGG-16's
   shapes.

Phases 9-12 run with ``MXTPU_NO_FUSED_STEP=1``: they measure the split path
that earlier slices recorded.

Run from the repo root: ``python3 chip_smoke.py [--seed N]``.
The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 without tensor cores,
# bf16 and fp16 on tensor cores.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# HBM bandwidth by the card name nvidia-smi prints (NVIDIA data sheets:
# H100 SXM5 80GB HBM3 3.35 TB/s, H100 PCIe 2.0 TB/s, H100 NVL 3.9 TB/s,
# H200 4.8 TB/s); the first name found in the card's wins
HBM_BYTES_PER_S = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12)]
PEAK_BYTES = 3.35e12   # the card of phase 1 sets it (hbm_bytes_per_s)

VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 32768, 1024, 16, 12, 2048, 2
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 4, 1e-4, 5   # phase 9 (bench.py)
REQUESTS = 4
OUT_DIR = "chiprun_out"
# device kernels counted as matrix products in the traced request (cuBLAS
# and CUTLASS kernel names; cuBLAS's Hopper bf16 kernels are named nvjet_*)
GEMM_NAME = re.compile(r"gemm|gemv|nvjet|cutlass", re.IGNORECASE)
KERNEL_LIBS = ("flash_attention_fwd", "flash_attention_fwd_tc")
AMP_REQUESTS = 4
AMP_CPU_SEQ = 512   # T of the card-vs-CPU check under amp
# a kernel's numbers in the `kernels` line: `ms`, `plain_ms` and `library_ms`
# time one call between two events (the host's dispatch where it is longer
# than the kernel), as in every earlier slice; `device_ms` and
# `library_device_ms` time the device's work alone (time_device)
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms", "library_device_ms")


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


# ---------------------------------------------------------------- measuring

def time_cuda(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` launches, each between
    two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_device(fn, reps=20, warmup=3, rounds=3):
    """Milliseconds of one call of ``fn`` on the device alone: the median
    over ``rounds`` of the mean over ``reps`` back-to-back calls between
    two CUDA events, queued behind a sleep kernel so that the events time
    the device's work and not the host's dispatch (``time_cuda`` times the
    dispatch where it is the longer). A round whose sleep ended before its
    calls were queued is redone with a longer sleep."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], 20_000_000   # about 10 ms at the H100's clocks
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end) / reps)
        elif cycles > 2_000_000_000:
            raise CheckFailed(f"time_device: the host could not queue {reps} "
                              f"calls within a sleep of {cycles} cycles")
        else:
            cycles *= 4
    return float(np.median(times))


def attention_bound(b, t_q, t_k, h, d, causal, q_offset, dtype_name):
    """Least time (ms) the card could take for one attention forward on
    these inputs, and what bounds it. Operations: 2*d for each scored
    (query, key) pair in Q K^T and 2*d in P V, counting only the pairs the
    causal mask keeps. Bytes: q, k, v read once, o written once."""
    rows = q_offset + np.arange(t_q)
    keys = np.clip(rows + 1, 0, t_k) if causal else np.full(t_q, t_k)
    pairs = float(b * h * keys.sum())
    flops = 4.0 * d * pairs
    item = 4 if dtype_name == "float32" else 2
    nbytes = float(item * (2 * b * t_q * h * d + 2 * b * t_k * h * d))
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hbm_bytes_per_s(card):
    for name, rate in HBM_BYTES_PER_S:
        if name in card:
            return rate
    raise CheckFailed(f"no HBM bandwidth on record for card {card!r}")


def bytes_bound(nbytes, flops):
    """(ms, what bounds it) for work that moves ``nbytes`` and does
    ``flops`` fp32 operations."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases

def phase_device():
    import torch

    print("phase 1: device", flush=True)
    if not torch.cuda.is_available():
        raise CheckFailed("torch.cuda.is_available() is false: this script "
                          "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    global PEAK_BYTES
    PEAK_BYTES = hbm_bytes_per_s(card)
    print(f"  HBM {PEAK_BYTES / 1e12:.2f} TB/s (data sheet, by name)",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    conv_weight_grad_precision()
    return card


def conv_weight_grad_precision():
    """LeNet's first convolution (1 -> 20 channels, 5x5, 28 px) at batch 8
    in fp32 on the card, TF32 off: its weight gradient from cuDNN and from
    the port's Convolution op against float64 on the CPU (largest gap over
    float64's max-abs). cuDNN's algorithm for this shape is not fp32-exact
    (nor TF32: the gap is not TF32's); the port's op takes the weight
    gradient off cuDNN, held to 1e-5."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 1, 28, 28, generator=gen, dtype=torch.float64)
    w = torch.randn(20, 1, 5, 5, generator=gen, dtype=torch.float64) * 0.2
    dy = torch.randn(8, 20, 24, 24, generator=gen, dtype=torch.float64)
    want = torch.nn.grad.conv2d_weight(x, w.shape, dy)
    conv = get_op("Convolution").fn
    attrs = {"kernel": (5, 5), "num_filter": 20, "no_bias": True}
    ctx = OpCtx(is_train=True, device=torch.device("cuda", 0))
    gaps = {}
    for route, fn in (("cudnn", lambda a, b: F.conv2d(a, b)),
                      ("port", lambda a, b: conv(ctx, attrs, a, b))):
        ww = w.float().cuda().requires_grad_()
        got = torch.autograd.grad(fn(x.float().cuda(), ww),
                                  ww, dy.float().cuda())[0]
        gaps[route] = float((got.double().cpu() - want).abs().max()
                            / want.abs().max())
    print("  fp32 conv weight gradient vs float64 (LeNet conv1, batch 8): "
          + json.dumps(gaps), flush=True)
    check(gaps["port"] <= 1e-5, f"the port's fp32 convolution weight "
          f"gradient within 1e-5 of float64's max-abs ({gaps['port']:.3g}; "
          f"cuDNN's {gaps['cudnn']:.3g})")
    return gaps


def phase_build():
    """Both kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import _native

    print("phase 2: build", flush=True)

    def build(name):
        t = time.perf_counter()
        return _native.build(name), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        built = dict(zip(KERNEL_LIBS, pool.map(build, KERNEL_LIBS)))
    secs = time.perf_counter() - t0
    out = {"wall_s": secs}
    for name, (path, lib_s) in built.items():
        log = _native.BUILD_LOGS.get(name, "(reused)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: " + line.strip(), flush=True)
        print(f"  built {os.path.relpath(path)} in {lib_s:.2f} s", flush=True)
        out[name + "_s"] = lib_s
    print(f"  both in {secs:.2f} s", flush=True)
    return out


def _qkv(shape_q, t_k, dtype, seed):
    import torch

    b, t_q, h, d = shape_q
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t_q, h, d), generator=g, device="cuda")
    k = torch.randn((b, t_k, h, d), generator=g, device="cuda")
    v = torch.randn((b, t_k, h, d), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def phase_kernel_vs_plain(seed):
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    print("phase 3: kernel vs plain", flush=True)
    cases = [
        # name, q shape, t_k, causal, q_offset, dtype, tolerance
        ("slice_fp32_causal", (BATCH, SEQ, HEADS, HIDDEN // HEADS), SEQ,
         True, 0, torch.float32, 1e-4),
        ("ragged_fp32_causal_qoff", (1, 200, 3, 64), 264, True, 64,
         torch.float32, 1e-4),
        ("ragged_fp32_noncausal_qoff", (1, 200, 3, 64), 264, False, 64,
         torch.float32, 1e-4),
        ("d128_fp32_causal", (BATCH, SEQ, HEADS // 2, 128), SEQ, True, 0,
         torch.float32, 1e-4),
        ("ragged_d50_fp32_causal", (BATCH, 1500, HEADS, 50), 1500, True, 0,
         torch.float32, 1e-4),
        # bf16/fp16: the tensor-core kernel, held to the fp32 plain version
        # on the same rounded inputs; the error is mostly the rounding of
        # the O(1) output and of P to the 16-bit type. fp16 carries 3 more
        # mantissa bits than bf16: its limit lies between its own reading
        # (1.1e-3 at this shape) and the bf16 kernel's (8.1e-3), so an fp16
        # path that lost precision to bf16's level fails
        ("slice_bf16_causal", (BATCH, SEQ, HEADS, HIDDEN // HEADS), SEQ,
         True, 0, torch.bfloat16, 2e-2),
        ("slice_fp16_causal", (BATCH, SEQ, HEADS, HIDDEN // HEADS), SEQ,
         True, 0, torch.float16, 3e-3),
        # phase 9's shape: the training step's batch of 4
        ("train_bf16_causal", (TRAIN_BATCH, SEQ, HEADS, HIDDEN // HEADS),
         SEQ, True, 0, torch.bfloat16, 2e-2),
        ("d128_bf16_causal", (BATCH, SEQ, HEADS // 2, 128), SEQ, True, 0,
         torch.bfloat16, 2e-2),
        # d = 50: rows of 100 bytes, the element-wise load path
        ("ragged_d50_bf16_causal", (BATCH, 1500, HEADS, 50), 1500, True, 0,
         torch.bfloat16, 2e-2),
        # head dim 256 (hidden 1024 in 4 heads): the split-over-d kernels
        ("d256_fp32_causal", (BATCH, SEQ, HEADS // 4, 256), SEQ, True, 0,
         torch.float32, 1e-4),
        ("d256_bf16_causal", (BATCH, SEQ, HEADS // 4, 256), SEQ, True, 0,
         torch.bfloat16, 2e-2),
        ("d256_fp16_causal", (BATCH, SEQ, HEADS // 4, 256), SEQ, True, 0,
         torch.float16, 3e-3),
    ]
    results = {}
    for i, (name, shp, t_k, causal, q_off, dtype, tol) in enumerate(cases):
        q, k, v = _qkv(shp, t_k, dtype, seed + i)
        got = flash_attention(q, k, v, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        # the plain version in fp32 on the same (rounded) inputs
        want = flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal, q_offset=q_off)
        err = float((got.float() - want).abs().max())
        dname = str(dtype).replace("torch.", "")
        bound_ms, bound_by = attention_bound(shp[0], shp[1], t_k, shp[2],
                                             shp[3], causal, q_off, dname)

        def run():
            return flash_attention(q, k, v, causal=causal, q_offset=q_off)

        ms = time_cuda(run)
        device_ms = time_device(run)
        plain_ms = time_cuda(lambda: flash_attention_reference(
            q, k, v, causal=causal, q_offset=q_off))
        # yardstick only: one library call computing the same function
        # (the port never calls it); with q_offset > 0 the causal mask is
        # not the library's, so there is no single call for that case
        library_ms = library_device_ms = None
        if not (causal and q_off):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)

            library_ms = time_cuda(library)
            library_device_ms = time_device(library)
        row = {"case": name, "q": list(shp), "t_k": t_k, "causal": causal,
               "q_offset": q_off, "dtype": dname, "max_abs_err": err,
               "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "device_ms": device_ms,
               "library_device_ms": library_device_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "frac_of_bound": bound_ms / device_ms,
               "vs_library": ms / library_ms if library_ms else None}
        print("  " + json.dumps(row), flush=True)
        check(np.isfinite(err) and err <= tol,
              f"{name}: max abs err {err:.3g} <= {tol}")
        results[name] = row
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return results


def make_weights(symbol, input_shapes, seed):
    """Random weights for every parameter of ``symbol``, from ``seed`` with
    numpy. Scales keep the attention scores and the logits spread, so the
    probabilities are peaked enough for the argmax check to mean something."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = symbol.infer_shape(**input_shapes)
    weights = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes:
            continue
        z = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("_gamma"):
            w = 1.0 + 0.1 * z
        elif name.endswith(("_beta", "_bias")):
            w = 0.02 * z
        elif name == "tok_embed_weight":
            w = z
        elif name == "transformer_pos_weight":
            w = 0.1 * z
        elif name == "head_weight":
            w = 0.125 * z
        else:
            w = 0.03 * z
        weights[name] = w.astype(np.float32)
    return weights


def lm_predictor(mx, layers, batch, weights, ctx):
    symbol = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=layers, hidden=HIDDEN, heads=HEADS,
        seq_len=SEQ)
    shapes = {"data": (batch, SEQ), "softmax_label": (batch, SEQ)}
    names = [n for n in symbol.list_arguments() if n not in shapes]
    arg, aux = mx.convert.params_from_numpy(
        {n: weights[n] for n in names}, {}, ctx)
    return mx.Predictor.from_arrays(symbol, arg, aux, shapes, ctx=ctx)


def check_probs(p):
    """A request's probabilities: fp32 of (BATCH * SEQ, VOCAB), finite,
    rows summing to 1 within 1e-4."""
    import torch

    check(tuple(p.shape) == (BATCH * SEQ, VOCAB) and p.dtype == torch.float32,
          f"probs {tuple(p.shape)} {p.dtype}")
    check(bool(torch.isfinite(p).all()), "probs all finite")
    row_err = float((p.sum(dim=1) - 1).abs().max())
    check(row_err <= 1e-4, f"rows sum to 1 within 1e-4 ({row_err:.2e})")


def traced_requests(batches, feed, forward, check_out, kernel):
    """Each of ``batches`` fed in place (``feed``) and answered by the
    captured forward (``forward``: a warm-up, a capture, replays) under the
    profiler, which counts the kernels the card ran in it whose names
    ``kernel`` picks (a replay calls no wrapper); ``check_out`` holds each
    answer. Returns the counts."""
    traced = []
    for x in batches:
        feed(x)
        counts, got = {}, []
        by_name, _ = traced_groups(lambda: got.append(forward()), {}, counts)
        traced.append(sum(counts[k] for k in by_name if kernel(k)))
        check_out(got[0])
    return traced


def timed_requests(batches, feed, forward, eager):
    """Every batch answered untraced by the captured forward and by the
    eager walk (``eager``) in turns; the host ms of each by mode."""
    ms = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        for x in batches:
            feed(x)
            ms[mode].append(timed(forward if mode == "captured"
                                  else eager)[1])
    return ms


def phase_slice(mx, layers, seed):
    import torch

    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    print(f"phase 4: the slice ({layers} layers, batch {BATCH}, T {SEQ}, "
          f"vocab {VOCAB}, {REQUESTS} requests)", flush=True)
    symbol = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=layers, hidden=HIDDEN, heads=HEADS,
        seq_len=SEQ)
    shapes = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}
    t0 = time.perf_counter()
    weights = make_weights(symbol, shapes, seed)
    n_params = sum(w.size for w in weights.values())
    pred = lm_predictor(mx, layers, BATCH, weights, mx.gpu(0))
    torch.cuda.synchronize()
    print(f"  {n_params / 1e6:.1f} M parameters; weights made and bound in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(pred.output_shapes == [(BATCH * SEQ, VOCAB)],
          f"output shape {pred.output_shapes} == [({BATCH * SEQ}, {VOCAB})]")

    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
               for _ in range(REQUESTS)]
    reset_launches()
    ex = pred._executor
    def feed(x):
        pred.set_input("data", x)

    def forward():
        return pred.forward().get_output_nd(0).data

    traced = traced_requests(
        batches, feed, forward, check_probs,
        lambda k: "flash_fwd" in k and "flash_fwd_tc" not in k)
    wrapper = flash_attention.launches
    wrapper_fp32 = flash_attention.launches_by_dtype["float32"]
    info = ex.forward_info()
    ms = timed_requests(batches, feed, forward,
                        lambda: ex.eager_forward()[0])
    check(traced == [layers] * REQUESTS,
          f"the card ran {layers} fp32 flash kernels in each captured "
          f"request (traced: {traced})")
    check(wrapper == 2 * layers and wrapper_fp32 == wrapper,
          f"the fp32 flash wrapper called {wrapper} == 2 x {layers} times "
          "(the warm-up's launches and the capture's), no other kernel")
    check(info["captures"] == 1 and info["drops"] == 0,
          f"one capture for the Predictor's binding ({info})")
    request_ms = ms["captured"]
    steady = float(np.median(request_ms))
    out = {"layers": layers, "request_ms": request_ms,
           "steady_request_ms": steady,
           "eager_request_ms": ms["eager"],
           "steady_eager_request_ms": float(np.median(ms["eager"])),
           "tokens_per_s": BATCH * SEQ / (steady / 1e3),
           "launches": sum(traced), "launches_traced": traced,
           "wrapper_calls": wrapper, "forward": info,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("  " + json.dumps(out), flush=True)
    probs = pred.get_output_nd(0).data

    # one more steady request, traced (after the launch count was read)
    traced_ms = []
    by_name = device_ms_by_kernel(lambda: traced_ms.append(
        timed(lambda: pred.forward(data=batches[-1]))[1]))
    check(by_name, "the profiler recorded device events for one request")
    flash_ms = sum(t for n, t in by_name.items() if "flash_fwd" in n)
    gemm_ms = sum(t for n, t in by_name.items()
                  if "flash_fwd" not in n and GEMM_NAME.search(n))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["traced_request"] = {
        "host_ms": traced_ms[0], "device_busy_ms": busy,
        "flash_ms": flash_ms, "gemm_ms": gemm_ms,
        "rest_ms": busy - flash_ms - gemm_ms,
        "idle_share": 1.0 - busy / steady,
        "idle_share_traced": 1.0 - busy / traced_ms[0],
        "top_kernels": [[n[:80], t] for n, t in top]}
    print("  traced request: " + json.dumps(out["traced_request"]),
          flush=True)
    check(flash_ms > 0, "the traced request ran the flash kernel")
    static = ex._eval_program._static
    out["output_copy_ms"] = time_cuda(lambda: [o.clone() for o in static])
    last_probs = probs.clone()
    del pred, probs
    torch.cuda.empty_cache()
    return out, weights, last_probs


def phase_card_vs_cpu(mx, weights, seed):
    import torch

    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    print("phase 5: card vs CPU at depth 2 (batch 1, T 2048)", flush=True)
    x = np.random.default_rng(seed + 2).integers(
        0, VOCAB, (1, SEQ)).astype(np.float32)
    outs, launches = {}, {}
    for label, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        pred = lm_predictor(mx, 2, 1, weights, ctx)
        reset_launches()
        pred.forward(data=x)
        outs[label] = pred.get_output(0)
        launches[label] = flash_attention.launches
        del pred
    torch.cuda.empty_cache()
    check(launches == {"gpu": 2, "cpu": 0},
          f"flash kernel launched {launches['gpu']} == 2 times on the card "
          f"and {launches['cpu']} == 0 on the CPU")
    err = float(np.abs(outs["gpu"] - outs["cpu"]).max())
    # log-probabilities hold every probability, the small ones too, to a
    # relative tolerance; underflows clamp alike on both sides
    tiny = np.finfo(np.float32).tiny
    log_err = float(np.abs(np.log(np.maximum(outs["gpu"], tiny))
                           - np.log(np.maximum(outs["cpu"], tiny))).max())
    agree = float((outs["gpu"].argmax(1) == outs["cpu"].argmax(1)).mean())
    print(f"  max prob {float(outs['cpu'].max()):.3f}; max abs err "
          f"{err:.3g}; max abs log-prob err {log_err:.3g}; argmax "
          f"agreement {agree:.5f}", flush=True)
    check(err <= 1e-4, f"card vs CPU max abs err {err:.3g} <= 1e-4")
    check(log_err <= 1e-3,
          f"card vs CPU max abs log-prob err {log_err:.3g} <= 1e-3")
    check(agree >= 0.999, f"argmax agreement {agree:.5f} >= 0.999")
    return {"max_abs_err": err, "max_abs_log_err": log_err,
            "argmax_agreement": agree, "launches": launches}


def timed(fn):
    """(result, host ms) of ``fn``, between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t) * 1e3


def device_ms_by_kernel(fn):
    """Milliseconds the card spent in each kernel or copy (by name) during
    ``fn``, from the profiler's device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    # host-side op entries also carry the device time of what they
    # launched; count only the device's own events
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def device_busy_ms(fn):
    """Milliseconds the card spent in kernels and copies during ``fn``
    (None if the profiler records none)."""
    return sum(device_ms_by_kernel(fn).values()) or None


def phase_rtc_vs_plain(seed):
    """The user kernels through NVRTC against their plain versions."""
    import torch

    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_examples as ex

    print("phase 6: rtc kernel vs plain", flush=True)
    print(f"  NVRTC {rtc.nvrtc_version()}, target {rtc.ARCH}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    results = {}
    for name, shape, dtype, offset in (
            ("axpy_logits_fp32", (BATCH * SEQ, VOCAB), "float32", 0),
            ("axpy_ragged_fp32", (1000003,), "float32", 0),
            ("axpy_logits_bf16", (BATCH * SEQ, VOCAB), "bfloat16", 0),
            # inputs at a 4-byte offset, the output aligned: no 16-byte
            # vector serves all three, the scalar loop runs
            ("axpy_offset_fp32", (BATCH * SEQ * VOCAB,), "float32", 1)):
        axpy = ex.axpy_kernel(dtype)
        tdt = getattr(torch, dtype)
        x, y = (_at_offset(torch.randn(shape, generator=g, device="cuda")
                           .to(tdt), offset) for _ in range(2))
        got = axpy(x, y)
        torch.cuda.synchronize()
        err = float((got.float() - ex.axpy_reference(x, y).float())
                    .abs().max())
        n = x.numel()
        bound_ms, bound_by = bytes_bound(3 * x.element_size() * n, 2 * n)
        row = {"case": name, "shape": list(shape), "dtype": dtype,
               "offset_bytes": offset * x.element_size(),
               "max_abs_err": err, "tol": 0.0,
               "compile_s": axpy.compile_s,
               "launch": ex.axpy_dims(n, x.element_size()),
               "ms": time_cuda(lambda: axpy(x, y)),
               "plain_ms": time_cuda(lambda: ex.axpy_reference(x, y)),
               # yardstick only: one library call for 2x + y
               "library_ms": time_cuda(lambda: torch.add(y, x, alpha=2.0)),
               "device_ms": time_device(lambda: axpy(x, y)),
               "library_device_ms": time_device(
                   lambda: torch.add(y, x, alpha=2.0)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        row["frac_of_bound"] = bound_ms / row["device_ms"]
        row["vs_library_device"] = row["device_ms"] / row["library_device_ms"]
        print("  " + json.dumps(row), flush=True)
        check(err == 0.0, f"{name}: axpy exact against 2x + y (err {err})")
        results[name] = row
        del x, y, got
    w, gr, m = (torch.randn((VOCAB, HIDDEN), generator=g, device="cuda")
                for _ in range(3))
    w2, m2 = w.clone(), m.clone()
    sgd = ex.sgd_mom_rtc(gr, w2, m2)
    sgd.push([gr], [w2, m2])
    torch.cuda.synchronize()
    want_w, want_m = ex.sgd_mom_reference(w, gr, m)
    err = max(float((w2 - want_w).abs().max()),
              float((m2 - want_m).abs().max()))
    n = w.numel()
    bound_ms, bound_by = bytes_bound(5 * 4 * n, 9 * n)
    row = {"case": "sgd_mom_embedding_fp32", "shape": [VOCAB, HIDDEN],
           "dtype": "float32", "max_abs_err": err, "tol": 1e-6,
           "compile_s": sgd.compile_s,
           "ms": time_cuda(lambda: sgd.push([gr], [w2, m2])),
           "plain_ms": time_cuda(lambda: ex.sgd_mom_reference(w, gr, m)),
           "library_ms": None,
           "device_ms": time_device(lambda: sgd.push([gr], [w2, m2])),
           "library_device_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print("  " + json.dumps(row), flush=True)
    check(err <= 1e-6, f"sgd_mom Rtc vs sgd_mom_update max abs err "
          f"{err:.3g} <= 1e-6")
    results["sgd_mom_embedding_fp32"] = row
    del w, gr, m, w2, m2, want_w, want_m

    # the launch path: host microseconds a launch on 4096 elements, where
    # the device's work is shorter than the host's
    xs, ys = (torch.randn(4096, generator=g, device="cuda")
              for _ in range(2))
    axpy = ex.axpy_kernel("float32")
    sgd = ex.sgd_mom_rtc(xs, ys.clone(), ys.clone())
    ws, ms_ = ys.clone(), ys.clone()
    host = {"cuda_kernel_axpy_us": host_us_per_launch(lambda: axpy(xs, ys)),
            "rtc_sgd_mom_push_us": host_us_per_launch(
                lambda: sgd.push([xs], [ws, ms_]))}
    print("  host per launch: " + json.dumps(host), flush=True)
    results["host_per_launch"] = host
    torch.cuda.empty_cache()
    return results


def _at_offset(x, offset):
    """``x`` copied into a contiguous view ``offset`` elements into a
    buffer (at offset 1 its base is not 16-byte aligned)."""
    if not offset:
        return x
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def host_us_per_launch(fn, reps=300, warmup=20):
    """Host microseconds of one call of ``fn``: the mean over ``reps``
    calls queued back to back, with no synchronisation among them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _chain(mx, logp, embed):
    """The mx.nd chain of phase 7 on (rows, VOCAB) log-probabilities and
    the (VOCAB, HIDDEN) embedding: the scores of the first HIDDEN columns,
    centred, against every embedding row, and what a sampler reads."""
    h = mx.nd.slice_axis(logp, axis=1, begin=0, end=HIDDEN)
    h = mx.nd.broadcast_sub(h, mx.nd.mean(h, axis=1, keepdims=True))
    scores = mx.nd.dot(h, embed, transpose_b=True) * (1.0 / HIDDEN ** 0.5)
    p = mx.nd.softmax(scores)
    vals, idx = mx.nd.topk(p, k=8, ret_typ="both")
    top = mx.nd.argmax(p, axis=1)
    kth = mx.nd.slice_axis(vals, axis=1, begin=7, end=8)
    kept = mx.nd.where(mx.nd.broadcast_greater_equal(p, kth), p,
                       mx.nd.zeros_like(p))
    return {"scores": scores, "p": p, "vals": vals, "idx": idx,
            "top": top, "kept_mass": mx.nd.sum(kept, axis=1)}


def phase_imperative(mx, weights, probs, seed):
    """The imperative path over the LM's full parameter set."""
    import torch

    from mxnet_tpu_torch import rtc_examples as ex

    print("phase 7: the imperative path at full width", flush=True)
    torch.cuda.reset_peak_memory_stats()
    gpu, args = mx.gpu(0), ex.SGD_MOM_ARGS
    shapes = {n: w.shape for n, w in weights.items()}
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    t0 = time.perf_counter()
    mx.random.seed(seed)
    w = {n: mx.random.normal(0.0, 0.05, s, ctx=gpu) for n, s in shapes.items()}
    g = {n: mx.random.normal(0.0, 1.0, s, ctx=gpu) for n, s in shapes.items()}
    m = {n: mx.random.normal(0.0, 0.01, s, ctx=gpu) for n, s in shapes.items()}
    mx.nd.waitall()
    out = {"params": len(shapes), "elements": n_params,
           "draw_s": time.perf_counter() - t0}
    check(all(a.context == gpu and a.dtype == torch.float32
              for d in (w, g, m) for a in d.values()),
          f"{3 * len(shapes)} arrays drawn on {gpu}, float32")
    sample = w["tok_embed_weight"].data
    check(abs(float(sample.std()) - 0.05) < 1e-3
          and abs(float(sample.mean())) < 1e-3,
          f"normal(0, 0.05) moments ({float(sample.mean()):.2e}, "
          f"{float(sample.std()):.5f})")

    # the main path's kernels, counted over this run only
    sgd_rtc = ex.sgd_mom_rtc(g["tok_embed_weight"], w["tok_embed_weight"],
                             m["tok_embed_weight"])
    axpy = ex.axpy_kernel("float32")
    sgd_rtc.launches = axpy.launches = 0

    def passes(key, fn):
        """Run a pass three times: the first (the caching allocator grows),
        a steady one, and one under the profiler for the device's busy
        time; keeps the host times and returns the steady result."""
        first, out[key + "_first_ms"] = timed(fn)
        del first
        res, out[key + "_ms"] = timed(fn)
        out[key + "_device_busy_ms"] = device_busy_ms(fn)
        return res

    new = passes("sgd_mom_update", lambda: {
        n: mx.nd.sgd_mom_update(w[n], g[n], m[n], **args) for n in shapes})
    copies = {n: (w[n].copy(), m[n].copy()) for n in shapes}
    _, out["rtc_sgd_mom_pass_ms"] = timed(lambda: [
        sgd_rtc.push([g[n]], list(copies[n])) for n in shapes])
    out["rtc_nvrtc_compiles_s"] = sgd_rtc.compile_s
    err = max(max(float((copies[n][0].data - new[n][0].data).abs().max()),
                  float((copies[n][1].data - new[n][1].data).abs().max()))
              for n in shapes)
    out["rtc_vs_op_max_abs_err"] = err
    check(err <= 1e-6, f"Rtc sgd_mom over {len(shapes)} parameters vs "
          f"mx.nd.sgd_mom_update: max abs err {err:.3g} <= 1e-6")
    # again, compiled: the pass's steady host time, and the device's busy
    # time over a third pass
    def rtc_pass():
        return [sgd_rtc.push([g[n]], list(copies[n])) for n in shapes]

    _, out["rtc_sgd_mom_pass_steady_ms"] = timed(rtc_pass)
    out["rtc_sgd_mom_pass_device_busy_ms"] = device_busy_ms(rtc_pass)
    out["rtc_sgd_mom_push_us"] = \
        out["rtc_sgd_mom_pass_steady_ms"] * 1e3 / len(shapes)
    del copies, new
    mean = {n: mx.nd.zeros(s, gpu) for n, s in shapes.items()}
    var = {n: mx.nd.zeros(s, gpu) for n, s in shapes.items()}
    adam_args = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-4,
                     rescale_grad=0.5, clip_gradient=1.0)
    adam = passes("adam_update", lambda: {
        n: mx.nd.adam_update(w[n], g[n], mean[n], var[n], **adam_args)
        for n in shapes})
    check(all(bool(torch.isfinite(a.data).all())
              for outs in adam.values() for a in outs),
          "adam_update outputs all finite")
    small = "layer0_ln1_gamma" if "layer0_ln1_gamma" in shapes else \
        min(shapes, key=lambda n: int(np.prod(shapes[n])))
    cpu_outs = mx.nd.adam_update(
        *(d[small].as_in_context(mx.cpu()) for d in (w, g, mean, var)),
        **adam_args)
    adam_err = max(float(np.abs(a.asnumpy() - b.asnumpy()).max())
                   for a, b in zip(adam[small], cpu_outs))
    check(adam_err <= 1e-6, f"adam_update on {small}: card vs CPU max abs "
          f"err {adam_err:.3g} <= 1e-6")
    del adam, mean, var, g, m

    # a chain of mx.nd ops on the phase-4 log-probabilities (4096, 32768)
    logp = mx.nd.log(mx.nd.maximum(mx.nd.NDArray(probs), 1e-30))
    embed = w["tok_embed_weight"]
    chain = passes("chain", lambda: _chain(mx, logp, embed))
    rows = 64
    ref = _chain(mx, logp.slice(0, rows).as_in_context(mx.cpu()),
                 embed.as_in_context(mx.cpu()))
    errs = {k: float(np.abs(chain[k].slice(0, rows).asnumpy()
                            - ref[k].asnumpy()).max())
            for k in ("scores", "p", "vals", "kept_mass")}
    agree = float(np.mean(chain["top"].slice(0, rows).asnumpy()
                          == ref["top"].asnumpy()))
    idx_agree = float(np.mean(chain["idx"].slice(0, rows).asnumpy()
                              == ref["idx"].asnumpy()))
    out.update(chain_max_abs_err=errs, chain_argmax_agreement=agree,
               chain_topk_index_agreement=idx_agree)
    print(f"  chain card vs CPU on rows 0-{rows - 1}: {errs}; argmax "
          f"agreement {agree}, top-8 index agreement {idx_agree}",
          flush=True)
    check(all(chain[k].context == mx.gpu(0) for k in chain),
          "chain outputs on the card")
    check(errs["scores"] <= 1e-3 and errs["p"] <= 1e-6
          and errs["vals"] <= 1e-6 and errs["kept_mass"] <= 1e-5,
          "chain card vs CPU: scores <= 1e-3, probabilities <= 1e-6, "
          "kept mass <= 1e-5")
    check(agree >= 0.98 and idx_agree >= 0.95,
          f"chain argmax agreement {agree} >= 0.98, top-8 indices "
          f"{idx_agree} >= 0.95")
    check(bool(torch.isfinite(chain["kept_mass"].data).all()),
          "chain outputs finite")
    del chain, ref, logp

    # a CustomOp whose forward pushes the axpy kernel
    class Axpy(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], axpy.push(in_data))

    @mx.operator.register("chip_smoke_axpy")
    class AxpyProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["x", "y"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Axpy()

    x, y = w["head_weight"], embed
    want = ex.axpy_reference(x.data, y.data)
    imperative = mx.nd.Custom(x, y, op_type="chip_smoke_axpy")
    symbol = mx.sym.Custom(mx.sym.Variable("x"), mx.sym.Variable("y"),
                           op_type="chip_smoke_axpy")
    (graph,) = symbol.bind(gpu, {"x": x, "y": y}).forward()
    torch.cuda.synchronize()
    check(torch.equal(imperative.data, want) and torch.equal(graph.data, want),
          "CustomOp pushing the axpy kernel: imperative and Executor.forward "
          "equal 2x + y")
    out["launches"] = {"rtc_sgd_mom": sgd_rtc.launches,
                       "rtc_axpy": axpy.launches}
    check(sgd_rtc.launches == 3 * len(shapes) and axpy.launches == 2,
          f"kernel launches on this path: sgd_mom {sgd_rtc.launches} == "
          f"3 x {len(shapes)}, axpy {axpy.launches} == 2")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("  " + json.dumps(out), flush=True)
    del w, imperative, graph
    torch.cuda.empty_cache()
    return out


def lm_executor(mx, layers, batch, seq, weights, ctx, amp_dtype,
                data_dtype="int32"):
    """The LM bound through ``Executor(..., amp_dtype=...)``, as the
    reference's executor group binds it under ``Module(amp=...)``: fp32
    weights (the first ``seq`` learned positions), token ids bound as
    ``data_dtype`` and an fp32 label."""
    symbol = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=layers, hidden=HIDDEN, heads=HEADS,
        seq_len=seq)
    shapes = {"data": (batch, seq), "softmax_label": (batch, seq)}
    names = [n for n in symbol.list_arguments() if n not in shapes]
    params = {n: weights[n] for n in names}
    params["transformer_pos_weight"] = params["transformer_pos_weight"][:seq]
    args, _ = mx.convert.params_from_numpy(params, {}, ctx)
    args["data"] = mx.nd.zeros(shapes["data"], ctx, dtype=data_dtype)
    args["softmax_label"] = mx.nd.zeros(shapes["softmax_label"], ctx)
    return mx.executor.Executor(symbol, ctx, args, amp_dtype=amp_dtype)


def phase_amp(mx, weights, seed):
    """The LM under bf16 mixed precision at full width: the tensor-core
    flash kernel's main path."""
    import torch

    from mxnet_tpu_torch.executor import _amp_cast
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    print(f"phase 8: the amp path (bf16; {LAYERS} layers, batch {BATCH}, T "
          f"{SEQ}, vocab {VOCAB}, {AMP_REQUESTS} requests)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe = lm_executor(mx, LAYERS, BATCH, SEQ, weights, mx.gpu(0), "bfloat16")
    torch.cuda.synchronize()
    print(f"  bound in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(seed + 8)
    # int32 ids pass the amp cast untouched (float32 ids would round in bf16)
    batches = [rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
               for _ in range(AMP_REQUESTS)]
    reset_launches()
    # each request goes in as the reference feeds it, forward(data=x): the
    # ids are copied into the bound array, so the captured forward stays
    # valid; the eager walk gets the same copy
    fed = []

    def feed(x):
        fed[:] = [x]

    def forward():
        return exe.forward(is_train=False, data=fed[0])[0].data

    def eager():
        exe.arg_dict["data"].data.copy_(torch.from_numpy(fed[0]))
        return exe.eager_forward()[0]

    traced = traced_requests(batches, feed, forward, check_probs,
                             lambda k: "flash_fwd" in k)
    launches = dict(flash_attention.launches_by_dtype)
    info = exe.forward_info()
    ms = timed_requests(batches, feed, forward, eager)
    check(traced == [LAYERS] * AMP_REQUESTS,
          f"the card ran {LAYERS} flash kernels in each captured bf16 "
          f"request (traced: {traced})")
    check(launches["bfloat16"] == 2 * LAYERS
          and launches["float32"] == 0 and launches["float16"] == 0,
          f"tensor-core flash wrapper called {launches['bfloat16']} == 2 x "
          f"{LAYERS} times (the warm-up's and the capture's), fp32 "
          f"{launches['float32']} == 0")
    check(info["captures"] == 1 and info["drops"] == 0,
          f"one capture for the executor's binding ({info})")
    request_ms = ms["captured"]
    steady = float(np.median(request_ms))
    out = {"layers": LAYERS, "request_ms": request_ms,
           "steady_request_ms": steady, "eager_request_ms": ms["eager"],
           "steady_eager_request_ms": float(np.median(ms["eager"])),
           "tokens_per_s": BATCH * SEQ / (steady / 1e3),
           "launches": sum(traced), "launches_traced": traced,
           "wrapper_calls": launches, "forward": info}
    probs = exe.outputs
    static = exe._eval_program._static
    out["output_copy_ms"] = time_cuda(lambda: [o.clone() for o in static])
    del static

    # one more steady request, traced (after the launch count was read);
    # then the casts of the bound arguments, the same kernels the request
    # runs first, timed apart on the device to split them out of the rest
    traced_ms = []
    by_name = device_ms_by_kernel(lambda: traced_ms.append(
        timed(lambda: exe.forward(is_train=False))[1]))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    cast_ms = time_device(lambda: [_amp_cast(n, a.data, torch.bfloat16)
                                 for n, a in exe.arg_dict.items()],
                        reps=3, warmup=1)
    check(by_name, "the profiler recorded device events for one request")
    flash_ms = sum(t for n, t in by_name.items() if "flash_fwd_tc" in n)
    other_flash = sum(t for n, t in by_name.items()
                      if "flash_fwd" in n and "flash_fwd_tc" not in n)
    gemm_ms = sum(t for n, t in by_name.items()
                  if "flash_fwd" not in n and GEMM_NAME.search(n))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["traced_request"] = {
        "host_ms": traced_ms[0], "device_busy_ms": busy,
        "flash_ms": flash_ms, "gemm_ms": gemm_ms, "amp_cast_ms": cast_ms,
        "rest_ms": busy - flash_ms - gemm_ms - cast_ms,
        "idle_share": 1.0 - busy / steady,
        "idle_share_traced": 1.0 - busy / traced_ms[0],
        "device_kernels": len(by_name),
        "top_kernels": [[n[:80], t] for n, t in top]}
    print("  " + json.dumps({k: v for k, v in out.items()
                             if k != "traced_request"}), flush=True)
    print("  traced request: " + json.dumps(out["traced_request"]),
          flush=True)
    check(flash_ms > 0 and other_flash == 0,
          "the traced request ran the tensor-core flash kernel and no other")

    # a feed that rebinds the ids (``arr[:] = x`` makes a new tensor, as the
    # reference's immutable arrays do) drops the graph: every such forward
    # is a warm-up, the eager walk on the side stream
    def rebound():
        exe.arg_dict["data"][:] = fed[0]
        return exe.forward(is_train=False)[0].data

    rebound_ms = []
    for x in batches + batches:
        feed(x)
        rebound_ms.append(timed(rebound)[1])
    after = exe.forward_info()
    out["rebound_feed_request_ms"] = rebound_ms
    out["rebound_feed_forward"] = after
    print(f"  requests fed by rebinding: {[round(t, 2) for t in rebound_ms]}"
          f" ms ({after})", flush=True)
    check(after["captures"] == 1 and after["drops"] == 1
          and after["warmups"] == 1 + 2 * AMP_REQUESTS,
          f"a rebound feed dropped the graph once and every such forward "
          f"warmed up ({after})")
    del exe, probs
    torch.cuda.empty_cache()

    # bf16 on the card against bf16 on the CPU, at depth 2
    x = np.random.default_rng(seed + 9).integers(
        0, VOCAB, (1, AMP_CPU_SEQ)).astype(np.int32)
    outs, by_ctx = {}, {}
    for label, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        exe = lm_executor(mx, 2, 1, AMP_CPU_SEQ, weights, ctx, "bfloat16")
        reset_launches()
        t0 = time.perf_counter()
        (res,) = exe.forward(data=x)
        outs[label] = res.asnumpy()
        by_ctx[label] = dict(flash_attention.launches_by_dtype)
        print(f"  depth 2 on {label}: {time.perf_counter() - t0:.2f} s",
              flush=True)
        del exe, res
    torch.cuda.empty_cache()
    check(by_ctx["gpu"]["bfloat16"] == 2 and sum(by_ctx["gpu"].values()) == 2
          and sum(by_ctx["cpu"].values()) == 0,
          f"flash launches at depth 2: card {by_ctx['gpu']}, CPU "
          f"{by_ctx['cpu']}")
    tiny = np.finfo(np.float32).tiny
    log_err = np.abs(np.log(np.maximum(outs["gpu"], tiny))
                     - np.log(np.maximum(outs["cpu"], tiny)))
    agree = float((outs["gpu"].argmax(1) == outs["cpu"].argmax(1)).mean())
    parity = {"max_abs_err": float(np.abs(outs["gpu"] - outs["cpu"]).max()),
              "max_abs_log_err": float(log_err.max()),
              "p999_abs_log_err": float(np.quantile(log_err, 0.999)),
              "mean_abs_log_err": float(log_err.mean()),
              "argmax_agreement": agree, "launches": by_ctx}
    out["card_vs_cpu"] = parity
    print("  card vs CPU (bf16, depth 2, batch 1, T "
          f"{AMP_CPU_SEQ}): " + json.dumps(parity), flush=True)
    # The limit is on the mean: logits are bf16 in both evaluations (the
    # head's FullyConnected returns bf16, as in the reference), and one bf16
    # step of a logit is 0.0625 at |logit| in [8, 16) and 0.125 in [16, 32),
    # where this model's largest logits lie (std about 4). Two correct bf16
    # evaluations that sum in another order round some of those logits one
    # step apart, and a top logit's step shifts its whole row through the
    # normaliser, so the max and the 99.9th percentile read bf16's step
    # (0.21 and 0.13 when only P's rounding in attention differs, on the
    # CPU); the mean reads the bulk (0.018 there). The tail is held at two
    # bf16 steps of a logit in [16, 32): a fault in one 64-row Q tile of
    # the 512 rows moves an eighth of the entries, past the 99.9th
    # percentile (0.128 on the card).
    check(parity["mean_abs_log_err"] <= 5e-2,
          f"card vs CPU mean abs log-prob err "
          f"{parity['mean_abs_log_err']:.3g} <= 5e-2")
    check(parity["p999_abs_log_err"] <= 0.25,
          f"card vs CPU 99.9th percentile abs log-prob err "
          f"{parity['p999_abs_log_err']:.3g} <= 0.25")
    check(agree >= 0.98, f"argmax agreement {agree:.5f} >= 0.98")

    # int32 ids above 256 fed into a float32-bound data: the feed rebinds
    # data, so the ids reach the embedding unrounded (bf16 holds integers
    # exactly only up to 256), as when data is bound as int32
    x = np.random.default_rng(seed + 10).integers(
        256, VOCAB, (1, AMP_CPU_SEQ)).astype(np.int32)
    fed = {}
    for data_dtype in ("float32", "int32"):
        exe = lm_executor(mx, 2, 1, AMP_CPU_SEQ, weights, mx.gpu(0),
                          "bfloat16", data_dtype)
        (res,) = exe.forward(data=x)
        fed[data_dtype] = (res.asnumpy(), str(exe.arg_dict["data"].dtype))
        del exe, res
    torch.cuda.empty_cache()
    agree = float((fed["float32"][0].argmax(1)
                   == fed["int32"][0].argmax(1)).mean())
    out["fed_ids"] = {"argmax_agreement": agree,
                      "max_abs_err": float(np.abs(fed["float32"][0]
                                                  - fed["int32"][0]).max()),
                      "bound_dtype_after_feed": fed["float32"][1]}
    print("  int32 ids fed into float32-bound data vs int32-bound: "
          + json.dumps(out["fed_ids"]), flush=True)
    check(agree == 1.0 and fed["float32"][1] == "torch.int32",
          f"fed int32 ids: data rebound as {fed['float32'][1]}, argmax "
          f"agreement with the int32 binding {agree} == 1")
    return out


TRAIN_CPU_SEQ = 512   # T of the card-vs-CPU training step
# device-time groups of the traced training step, by the host range that
# launched the kernels: the autograd engine names each backward node, and
# the script wraps the fused head's forward, the amp casts and the update
TRAIN_RANGES = {
    "attn_bwd_recompute": ("autograd::engine::evaluate_function: "
                           "_FlashAttentionBackward",),
    "fused_head": ("chip_smoke::fused_head_forward",
                   "autograd::engine::evaluate_function: _FusedCEBackward"),
    "amp_cast": ("chip_smoke::amp_cast",),
    "adam_update": ("chip_smoke::adam_update",),
}


def lm_module(mx, layers, batch, seq, weights, ctx, amp, fused, lr=TRAIN_LR):
    """The LM as ``bench.py`` trains it: ``Module(amp=...)`` bound at
    (batch, seq), the given fp32 weights (the first ``seq`` learned
    positions) through ``init_params(arg_params=...)``, Adam at ``lr``."""
    symbol = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=layers, hidden=HIDDEN, heads=HEADS,
        seq_len=seq, fused_head=fused)
    mod = mx.mod.Module(symbol, context=ctx, amp=amp)
    mod.bind(data_shapes=[("data", (batch, seq))],
             label_shapes=[("softmax_label", (batch, seq))])
    params = {n: weights[n] for n in mod._param_names}
    params["transformer_pos_weight"] = params["transformer_pos_weight"][:seq]
    args, _ = mx.convert.params_from_numpy(params, {}, ctx)
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    return mod


def lm_batch(mx, rng, batch, seq, ctx):
    """Random int32 tokens; labels the next token, -1 at the end."""
    x = rng.integers(0, VOCAB, (batch, seq)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.float32)
    y[:, -1] = -1
    return mx.io.DataBatch(data=[mx.nd.array(x, ctx, dtype="int32")],
                           label=[mx.nd.array(y, ctx)]), y


def _kernels_under(evt):
    """Device kernels launched by a host event and its children."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _kernels_under(child)
    return out


def traced_groups(fn, ranges=TRAIN_RANGES, counts=None, spans=None):
    """Device ms of ``fn`` by kernel name, and the kernels (name, ms) under
    each host range of ``ranges``, from one profiler run; ``counts`` (a
    dict) gets the number of launches by kernel name, ``spans`` (a list)
    each kernel's (start, end) in µs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    # the record_function ranges also show as device-side annotations that
    # span their kernels: count kernels and copies only
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("chip_smoke::")
               and e.self_device_time_total > 0}
    if counts is not None:
        counts.update({e.key: e.count for e in prof.key_averages()
                       if e.key in by_name})
    if spans is not None:
        spans += [(e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.key in by_name and "Mem" not in e.key]
    groups = {g: [] for g in ranges}
    for evt in prof.events():
        for g, names in ranges.items():
            if evt.name in names:
                groups[g] += [(k.name, k.duration / 1e3)
                              for k in _kernels_under(evt)]
    return by_name, groups


def phase_train(mx, weights, seed):
    """The transformer LM training through Module(amp="bfloat16") at
    bench.py's accelerator width: fused head, Adam, a repeated batch."""
    import torch

    from mxnet_tpu_torch import executor as texe
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    print(f"phase 9: training (bf16 amp, fused head, Adam lr {TRAIN_LR}; "
          f"{LAYERS} layers, batch {TRAIN_BATCH}, T {SEQ}, vocab {VOCAB}, "
          f"{TRAIN_STEPS} steps)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.perf_counter()
    mod = lm_module(mx, LAYERS, TRAIN_BATCH, SEQ, weights, gpu, "bfloat16",
                    True)
    torch.cuda.synchronize()
    ex = mod._exec_group._executor
    n_params = sum(a.size for n, a in ex.arg_dict.items()
                   if n in mod._param_names)
    out = {"layers": LAYERS, "batch": TRAIN_BATCH, "seq": SEQ,
           "params": n_params, "bind_s": time.perf_counter() - t0,
           # parameters, gradients and Adam's two moments, fp32
           "expected_state_gb": 4 * 4 * n_params / 1e9,
           # one fp32 score tensor of the attention recompute
           "expected_scores_gb": 4 * TRAIN_BATCH * HEADS * SEQ * SEQ / 1e9}
    print(f"  {n_params / 1e6:.1f} M parameters bound in "
          f"{out['bind_s']:.1f} s", flush=True)
    batch, y = lm_batch(mx, np.random.default_rng(seed + 11), TRAIN_BATCH,
                        SEQ, gpu)
    valid = torch.from_numpy(y.reshape(-1) != -1).to(gpu.torch_device)
    tokens = TRAIN_BATCH * SEQ

    reset_launches()
    step_ms, losses, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = flash_attention.launches_by_dtype["bfloat16"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(flash_attention.launches_by_dtype["bfloat16"]
                        - before)
        losses.append(float(mod.get_outputs()[0].data[valid].mean()))
        if i == 0:
            # the grad arrays keep step 1's gradients through the update
            bad = [n for n, g in ex.grad_dict.items()
                   if not bool(torch.isfinite(g.data).all())]
            check(not bad and len(ex.grad_dict) == len(mod._param_names),
                  f"all {len(ex.grad_dict)} gradients of step 1 finite")
    launches = dict(flash_attention.launches_by_dtype)
    check(all(np.isfinite(losses)), f"mean NLL finite: {losses}")
    check(per_step == [LAYERS] * TRAIN_STEPS
          and launches["float32"] == 0 and launches["float16"] == 0,
          f"bf16 flash kernel launched {per_step} times a step == "
          f"{LAYERS}, no other")
    check(losses[-1] < losses[0], f"mean NLL on the repeated batch at step "
          f"{TRAIN_STEPS} {losses[-1]:.4f} < step 1's {losses[0]:.4f}")
    steady = float(np.median(step_ms[1:]))
    out.update(step_ms=step_ms, first_step_ms=step_ms[0],
               steady_step_ms=steady, tokens_per_s=tokens / (steady / 1e3),
               launches=launches["bfloat16"], mean_nll=losses)

    # a sixth step under the profiler, its groups by host range
    fused_op = get_op("FusedCrossEntropyHead")
    fused_fn, amp_cast = fused_op.fn, texe._amp_cast

    def fused_traced(*a):
        with torch.profiler.record_function("chip_smoke::fused_head_forward"):
            return fused_fn(*a)

    def cast_traced(*a):
        with torch.profiler.record_function("chip_smoke::amp_cast"):
            return amp_cast(*a)

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        with torch.profiler.record_function("chip_smoke::adam_update"):
            mod.update()

    traced_ms = []
    fused_op.fn, texe._amp_cast = fused_traced, cast_traced
    try:
        by_name, groups = traced_groups(
            lambda: traced_ms.append(timed(step)[1]))
    finally:
        fused_op.fn, texe._amp_cast = fused_fn, amp_cast
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(by_name, "the profiler recorded device events for one step")
    bad = [n for n, g in ex.grad_dict.items()
           if not bool(torch.isfinite(g.data).all())]
    check(not bad, "all gradients of the traced step finite")
    busy = sum(by_name.values())
    split = {"flash_fwd": sum(t for n, t in by_name.items()
                              if "flash_fwd_tc" in n)}
    for g, ks in groups.items():
        split[g] = sum(t for _, t in ks)
    # GEMMs of the forward and the backward outside those groups (the
    # recompute's and the head's products are in theirs)
    grouped_gemm = sum(t for ks in groups.values() for n, t in ks
                       if GEMM_NAME.search(n))
    split["gemm"] = sum(t for n, t in by_name.items()
                        if GEMM_NAME.search(n) and "flash" not in n) \
        - grouped_gemm
    split["rest"] = busy - sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["traced_step"] = {
        "host_ms": traced_ms[0], "device_busy_ms": busy, "split_ms": split,
        "idle_share": 1.0 - busy / steady,
        "idle_share_traced": 1.0 - busy / traced_ms[0],
        "device_kernels": len(by_name),
        "top_kernels": [[n[:80], t] for n, t in top]}
    print("  " + json.dumps({k: v for k, v in out.items()
                             if k != "traced_step"}), flush=True)
    print("  traced step: " + json.dumps(out["traced_step"]), flush=True)
    check(split["flash_fwd"] > 0 and split["attn_bwd_recompute"] > 0,
          "the traced step ran the flash kernel and its recompute")
    del mod, ex, batch
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = train_card_vs_cpu(mx, weights, seed)
    out["train_lm_example"] = train_example()
    return out


def train_card_vs_cpu(mx, weights, seed):
    """One fp32 training step (forward and backward) at depth 2, batch 1,
    T 512 on the card and on the CPU, with the fused and the dense head.
    TF32 is off (phase 1). The per-token NLL must agree within 1e-4, and
    every gradient array within 1e-3 of its own max-abs.

    The CPU's ReLUs take the card's masks (which inputs are positive): a
    ReLU input within the two devices' rounding of 0 passes the gradient on
    one device and not on the other, and moves one row of that layer's
    ``ff1_weight`` by far more than rounding (1.5e-2 of its max-abs at seed
    0). With the card's masks both devices differentiate the same function,
    so every array is held to 1e-3. The units whose mask the CPU would have
    set otherwise are counted (``relu_masks_differ``, per layer)."""
    import torch

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    act = get_op("Activation")
    act_fn, card_masks, flips = act.fn, [], []

    def act_on_card(ctx, attrs, data):
        card_masks.append((data > 0).cpu())
        return act_fn(ctx, attrs, data)

    def act_with_card_mask(ctx, attrs, data):
        assert attrs.get("act_type", "relu") == "relu"
        mask = card_masks[len(flips)]
        flips.append(int((mask != (data > 0)).sum()))
        return data.masked_fill(~mask, 0.0)

    res = {}
    for fused in (True, False):
        got = {}
        for label, ctx, fn in (("gpu", mx.gpu(0), act_on_card),
                               ("cpu", mx.cpu(), act_with_card_mask)):
            mod = lm_module(mx, 2, 1, TRAIN_CPU_SEQ, weights, ctx, None,
                            fused)
            batch, y = lm_batch(mx, np.random.default_rng(seed + 12), 1,
                                TRAIN_CPU_SEQ, ctx)
            reset_launches()
            t0 = time.perf_counter()
            act.fn = fn
            try:
                mod.forward(batch, is_train=True)
            finally:
                act.fn = act_fn
            mod.backward()
            out = mod.get_outputs()[0].asnumpy()
            keep = y.reshape(-1) != -1
            lab = y.reshape(-1)[keep].astype(int)
            nll = out[keep] if fused else -np.log(out[keep, lab])
            grads = {n: g.asnumpy() for n, g in
                     mod._exec_group._executor.grad_dict.items()}
            got[label] = (nll, grads, dict(flash_attention.launches_by_dtype),
                          time.perf_counter() - t0)
            del mod, batch
        torch.cuda.empty_cache()
        nll_err = float(np.abs(got["gpu"][0] - got["cpu"][0]).max())
        rel = {}
        for n, want in got["cpu"][1].items():
            diff = np.abs(got["gpu"][1][n] - want)
            rel[n] = float(diff.max() / max(np.abs(want).max(), 1e-30))
        worst = max(rel, key=rel.get)
        head = "fused" if fused else "dense"
        res[head] = {"relu_masks_differ": list(flips),
                     "nll_max_abs_err": nll_err, "grad_max_rel_err": rel[worst],
                     "grad_worst": worst,
                     "grad_median_rel_err": float(np.median(list(rel.values()))),
                     "grad_rel_err": rel,
                     "launches": {k: v[2] for k, v in got.items()},
                     "seconds": {k: v[3] for k, v in got.items()}}
        card_masks.clear()
        flips.clear()
        print(f"  card vs CPU, fp32 step, {head} head: "
              + json.dumps(res[head]), flush=True)
    for head, r in res.items():
        check(r["launches"]["gpu"]["float32"] == 2
              and sum(r["launches"]["cpu"].values()) == 0,
              f"{head}: fp32 flash launched 2 times on the card, none on "
              "the CPU")
        check(len(r["relu_masks_differ"]) == 2,
              f"{head}: the CPU step took the card's 2 ReLU masks")
        check(r["nll_max_abs_err"] <= 1e-4, f"{head}: card vs CPU NLL "
              f"{r['nll_max_abs_err']:.3g} <= 1e-4")
        check(r["grad_max_rel_err"] <= 1e-3,
              f"{head}: every gradient array within 1e-3 of its max-abs "
              f"(worst {r['grad_worst']}: {r['grad_max_rel_err']:.3g})")
    return res


def train_example():
    """``examples/train_lm.py`` at its defaults on the card: the
    reference's gate, perplexity below 3.5 after 800 steps."""
    from mxnet_tpu_torch.examples import train_lm

    t0 = time.perf_counter()
    try:
        ppl = train_lm.main([])
    except AssertionError as e:
        raise CheckFailed(f"train_lm: perplexity {e} >= 3.5 after 800 steps")
    secs = time.perf_counter() - t0
    check(ppl < 3.5, f"train_lm on the card: perplexity {ppl:.3f} < 3.5 "
          f"after 800 steps ({secs:.1f} s)")
    return {"perplexity": ppl, "seconds": secs}


# phase 10: bench.py's accelerator ResNet-50 config (bench.py:661-683,
# 943-954, 981): batch 256, 224 px, 1000 classes, bf16 amp, SGD
FIT_LAYERS, FIT_CLASSES, FIT_PX, FIT_BATCH, FIT_BATCHES = 50, 1000, 224, 256, 8
FIT_SCORE_BATCHES = 2
FIT_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FIT_GFLOP_PER_IMAGE = 24.6   # forward and backward (bench.py:206)
# the card-vs-CPU step: the docs/perf.md "Hot-loop parity" config
FIT_CPU_BATCH, FIT_CPU_PX, FIT_CPU_CLASSES = 8, 64, 16
# the traced batch's groups: each op's forward under a range of the script,
# each backward under the autograd engine's node
_NODE = "autograd::engine::evaluate_function: "
FIT_OPS = {"conv_fwd": ("Convolution",), "bn_fwd": ("BatchNorm",),
           "pool": ("Pooling",), "relu_add": ("Activation", "elemwise_add"),
           "fc_softmax": ("FullyConnected", "SoftmaxOutput", "Flatten")}
FIT_RANGES = {
    "conv_fwd": ("chip_smoke::conv_fwd",),
    "conv_bwd": (_NODE + "ConvolutionBackward0",),
    "bn_fwd": ("chip_smoke::bn_fwd",),
    "bn_bwd": (_NODE + "_BatchNormTrainBackward",),
    "pool": ("chip_smoke::pool", _NODE + "MaxPool2DWithIndicesBackward0",
             _NODE + "MeanBackward1"),
    "relu_add": ("chip_smoke::relu_add", _NODE + "ReluBackward0",
                 _NODE + "AddBackward0"),
    "fc_softmax": ("chip_smoke::fc_softmax", _NODE + "AddmmBackward0",
                   _NODE + "_SoftmaxOutputBackward"),
    "amp_cast": ("chip_smoke::amp_cast", _NODE + "ToCopyBackward0"),
    "sgd_update": ("chip_smoke::sgd_update",),
}


def resnet_symbol(mx, classes, px):
    return mx.models.resnet.get_symbol(num_classes=classes,
                                       num_layers=FIT_LAYERS,
                                       image_shape=f"3,{px},{px}",
                                       layout="NCHW")


def resnet_weights(symbol, batch, px, seed):
    return net_weights(symbol, (batch, 3, px, px), seed)


def net_weights(symbol, data_shape, seed):
    """Random numpy arguments and aux states of ``symbol`` for ``data``
    of ``data_shape``: He-scaled weights, gammas near 1, small betas and
    biases, moving means near 0 and moving variances near 1."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data=data_shape, softmax_label=data_shape[:1])
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        z = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("_gamma"):
            w = 1.0 + 0.1 * z
        elif name.endswith(("_beta", "_bias")):
            w = 0.02 * z
        else:
            w = z * np.sqrt(2.0 / np.prod(shape[1:]))
        args[name] = w.astype(np.float32)
    aux = {}
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        z = rng.standard_normal(shape, dtype=np.float32)
        aux[name] = (1.0 + 0.1 * np.abs(z) if name.endswith("_var")
                     else 0.1 * z).astype(np.float32)
    return args, aux


def _wrap_ops(names, label):
    """Wrap the registered bodies of ``names`` in a profiler range; returns
    what restores them."""
    import torch

    from mxnet_tpu_torch.ops import get_op

    saved = []
    for name in names:
        op = get_op(name)
        fn = op.fn

        def ranged(*a, _fn=fn):
            with torch.profiler.record_function(label):
                return _fn(*a)

        saved.append((op, fn))
        op.fn = ranged
    return saved


def phase_fit(mx, seed):
    """ResNet-50 training through Module.fit at bench.py's accelerator
    config, the traced batch, score, and the correctness limits."""
    import torch

    print(f"phase 10: ResNet-{FIT_LAYERS} Module.fit (bf16 amp, SGD "
          f"{FIT_SGD}; batch {FIT_BATCH}, {FIT_PX} px, {FIT_CLASSES} "
          f"classes, {FIT_BATCHES} batches)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 20)
    n = FIT_BATCH * FIT_BATCHES
    x = rng.standard_normal((n, 3, FIT_PX, FIT_PX), dtype=np.float32)
    y = rng.integers(0, FIT_CLASSES, n).astype(np.float32)
    out = {"batch": FIT_BATCH, "px": FIT_PX, "classes": FIT_CLASSES,
           "layers": FIT_LAYERS, "batches": FIT_BATCHES,
           "data_s": time.perf_counter() - t0,
           "h2d_bytes_per_batch": x[:FIT_BATCH].nbytes,
           "d2h_bytes_per_batch": 4 * FIT_BATCH * FIT_CLASSES}
    train = mx.io.NDArrayIter(x, y, batch_size=FIT_BATCH)
    mod = mx.mod.Module(resnet_symbol(mx, FIT_CLASSES, FIT_PX), context=gpu,
                        amp="bfloat16")
    # step 1 starts when fit has bound and initialised (the end of
    # init_optimizer); every step ends in the metric's copy of the outputs
    # to the host, which waits for the step's kernels
    ready, stamps = [], []
    init_optimizer = mod.init_optimizer

    def init_optimizer_marked(*a, **k):
        init_optimizer(*a, **k)
        torch.cuda.synchronize()
        ready.append(time.perf_counter())

    mod.init_optimizer = init_optimizer_marked
    metric = mx.metric.create("acc")
    mx.random.seed(seed + 20)
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=metric, num_epoch=1, optimizer="sgd",
            optimizer_params=FIT_SGD,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    out["fit_s"] = time.perf_counter() - t0
    out["setup_s"] = ready[0] - t0
    step_ms = list(np.diff(ready + stamps) * 1e3)
    check(len(step_ms) == FIT_BATCHES, f"fit ran {len(step_ms)} == "
          f"{FIT_BATCHES} batches")
    steady = float(np.median(step_ms[2:]))
    out.update(step_ms=step_ms, first_step_ms=step_ms[0],
               steady_step_ms=steady,
               images_per_s=FIT_BATCH / (steady / 1e3),
               tflops_per_s=FIT_GFLOP_PER_IMAGE * FIT_BATCH / steady / 1e6,
               train_accuracy=metric.get()[1])
    print(f"  fit: setup {out['setup_s']:.1f} s, step 1 {step_ms[0]:.1f} ms, "
          f"steady {steady:.1f} ms, {out['images_per_s']:.1f} img/s",
          flush=True)

    _, aux = mod.get_params()
    aux = {n: a.asnumpy() for n, a in aux.items()}
    bad = [n for n, a in aux.items() if not np.isfinite(a).all()
           or not (a != (1.0 if n.endswith("_var") else 0.0)).any()]
    check(not bad and len(aux) == 2 * 51, f"all {len(aux)} moving "
          "statistics finite and moved from their start (mean 0, var 1)")

    # one more batch, traced: the iterator's host work, the feed's copy to
    # the card, forward and backward, the update and the metric's copy back
    ex = mod._exec_group._executor
    train.reset()
    batch, traced = trace_fit_step(mx, mod, train, metric)
    bad = [n for n, g in ex.grad_dict.items()
           if not bool(torch.isfinite(g.data).all())]
    check(not bad and len(ex.grad_dict) == len(mod._param_names),
          f"all {len(ex.grad_dict)} gradients of the traced batch finite")
    probs = mod.get_outputs()[0].asnumpy()
    lab = batch.label[0].asnumpy().astype(int)
    nll = float(-np.log(np.maximum(probs[np.arange(len(lab)), lab],
                                   1e-30)).mean())
    check(np.isfinite(nll), f"the traced batch's mean NLL {nll:.4f} finite")
    out["traced_step"] = dict(
        traced, mean_nll=nll,
        idle_share=1.0 - traced["device_busy_ms"] / steady,
        idle_share_traced=1.0 - traced["device_busy_ms"]
        / traced["host_ms"])
    print("  traced batch: " + json.dumps(out["traced_step"]), flush=True)

    # the feed's copy of one batch from pageable host memory, alone (the
    # profiler of a later phase does not always record it in the trace)
    host_batch = batch.data[0].data
    out["traced_step"]["feed_copy_ms"] = time_cuda(
        lambda: host_batch.to(gpu.torch_device), reps=5, warmup=1)
    score_it = mx.io.NDArrayIter(x[:FIT_SCORE_BATCHES * FIT_BATCH],
                                 y[:FIT_SCORE_BATCHES * FIT_BATCH],
                                 batch_size=FIT_BATCH)
    score_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = dict(mod.score(score_it, "acc"))["accuracy"]
        score_s.append(time.perf_counter() - t0)
    check(np.isfinite(acc), f"score accuracy {acc} finite")
    out["score"] = {"accuracy": acc, "seconds": score_s,
                    "images_per_s": FIT_SCORE_BATCHES * FIT_BATCH
                    / score_s[-1]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("  " + json.dumps({k: v for k, v in out.items()
                             if k != "traced_step"}), flush=True)
    del mod, ex, train, score_it, x, y
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = fit_card_vs_cpu(mx, seed)
    out["card_vs_cpu_bf16"] = fit_card_vs_cpu_bf16(mx, seed)
    out["train_cifar10_example"] = cifar_example()
    return out


def _cpu_batch(mx, seed, ctx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((FIT_CPU_BATCH, 3, FIT_CPU_PX, FIT_CPU_PX),
                            dtype=np.float32)
    y = rng.integers(0, FIT_CPU_CLASSES, FIT_CPU_BATCH).astype(np.float32)
    return mx.io.DataBatch(data=[mx.nd.array(x, ctx)],
                           label=[mx.nd.array(y, ctx)]), y


def _small_resnet(mx, ctx, amp, for_training, weights):
    mod = mx.mod.Module(resnet_symbol(mx, FIT_CPU_CLASSES, FIT_CPU_PX),
                        context=ctx, amp=amp)
    mod.bind(data_shapes=[("data", (FIT_CPU_BATCH, 3, FIT_CPU_PX,
                                    FIT_CPU_PX))],
             label_shapes=[("softmax_label", (FIT_CPU_BATCH,))],
             for_training=for_training)
    args, aux = mx.convert.params_from_numpy(*weights, ctx)
    mod.init_params(arg_params=args, aux_params=aux)
    return mod


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f64_step(mx, symbol, weights, x, y, optimizer, label):
    """The step of :func:`step_card_vs_cpu` in float64 on the CPU, through
    an Executor and the Module's ``optimizer`` rule: the yardstick of both
    fp32 steps' accuracy."""
    ctx = mx.cpu()
    arg_w, aux_w = weights
    names = [n for n in symbol.list_arguments() if n in arg_w]
    args = {n: mx.nd.array(arg_w[n], ctx, dtype="float64") for n in names}
    grads = {n: mx.nd.zeros(args[n].shape, ctx, dtype="float64")
             for n in names}
    aux = {n: mx.nd.array(aux_w[n], ctx, dtype="float64") for n in aux_w}
    args["data"] = mx.nd.array(x, ctx, dtype="float64")
    args[label] = mx.nd.array(y, ctx)
    ex = mx.executor.Executor(symbol, ctx, args, grads, "write", aux)
    ex.forward(is_train=True)
    ex.backward()
    outs = [o.asnumpy() for o in ex.outputs]
    g = {n: a.asnumpy() for n, a in grads.items()}
    name, params = optimizer
    opt = mx.optimizer.create(name, sym=symbol,
                              param_idx2name=dict(enumerate(names)),
                              rescale_grad=1.0 / len(y), **params)
    mx.optimizer.get_updater(opt).update_multi(
        list(range(len(names))), [grads[n] for n in names],
        [args[n] for n in names])
    return outs, g, {n: a.asnumpy() for n, a in ex.aux_dict.items()}, \
        {n: args[n].asnumpy() for n in names}


def fit_card_vs_cpu(mx, seed):
    """One fp32 SGD step of ResNet-50 at batch 8, 64 px, 16 classes on the
    card and on the CPU from identical weights and aux; TF32 is off (phase
    1). Held: the per-example NLL within 1e-4, every gradient array within
    1e-3 of its max-abs, the moving statistics after the step and the
    updated weights within 1e-5 of theirs.

    The CPU takes the card's ReLU masks and max-pool choices, as phase 9
    does: an input within the devices' rounding of 0, or of its window's
    maximum, would otherwise route its gradient differently on each. The
    units the CPU would have set otherwise are counted.

    Some arrays of this step cannot be reproduced to those limits in fp32
    at all (``mxnet_tpu_torch/tools/fp32_step_spread.py``): two runs on
    the card (cuDNN's backward sums in no fixed order), or on the CPU with 8
    and 1 threads, part bn0_gamma's gradient by 1.6e-3 and 1.7e-3 of its
    max-abs (many terms that nearly cancel), and the update carries a
    gradient's fp32 noise into a beta 60x smaller than its gradient
    (bn_data_beta, 1.7e-5 apart between two runs on the card, one with
    ``cudnn.deterministic``). So the same step also runs in float64 on the
    CPU, on the same masks: an array past its limit passes when the card's
    distance to the float64 step is at most twice the CPU's fp32 step's,
    i.e. the card is as accurate as the CPU."""
    symbol = resnet_symbol(mx, FIT_CPU_CLASSES, FIT_CPU_PX)
    weights = resnet_weights(symbol, FIT_CPU_BATCH, FIT_CPU_PX, seed + 21)
    batch, y = _cpu_batch(mx, seed + 22, mx.cpu())
    return step_card_vs_cpu(mx, symbol, weights, batch.data[0].asnumpy(), y,
                            f"fp32 step at batch {FIT_CPU_BATCH}, "
                            f"{FIT_CPU_PX} px")


def _nll_held(y):
    """``step_card_vs_cpu``'s default hold on the outputs: the per-example
    NLL of the first (class probabilities) within 1e-4."""
    def held(gpu, cpu):
        nll = [-np.log(o[0][np.arange(len(y)), y.astype(int)])
               for o in (gpu, cpu)]
        err = float(np.abs(nll[0] - nll[1]).max())
        return ({"nll_max_abs_err": err},
                bool(np.isfinite(nll[0]).all() and err <= 1e-4),
                f"card vs CPU per-example NLL {err:.3g} <= 1e-4")
    return held


def step_card_vs_cpu(mx, symbol, weights, x, y, what,
                     optimizer=("sgd", FIT_SGD), label="softmax_label",
                     replay=None, held=None):
    """One fp32 step of ``symbol`` under ``optimizer`` (a name and its
    parameters) from the numpy ``weights`` (args, aux) on the batch ``x``,
    ``y`` (fed as ``label``), on the card, on the CPU on the card's ReLU
    masks and max-pool choices, and in float64 on the CPU on the same;
    every Dropout draws the same masks on all three. ``replay`` maps op
    names to empty dicts: each such op's outputs on the card, kept with its
    inputs under ``"card"``, are the CPU's and the float64 step's outputs
    too, and their own outputs are kept under ``"cpu"`` and ``"f64"``.
    ``held(card_outputs, cpu_outputs)`` gives (report, passed, message) on
    the graph's outputs, by default :func:`_nll_held`. Held as
    :func:`fit_card_vs_cpu` says; returns the gaps."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import get_op, nn as tnn
    from mxnet_tpu_torch.ops.nn import _pair

    act, pool = get_op("Activation"), get_op("Pooling")
    act_fn, pool_fn = act.fn, pool.fn
    replay = replay or {}
    shared = {name: (get_op(name), get_op(name).fn) for name in replay}
    held = held or _nll_held(y)
    keep_mask = tnn.keep_mask
    masks, argmax, flips = [], [], {"relu": [], "max_pool": []}
    drawn = []
    def shared_mask(gen, keep, shape, device):
        g = torch.Generator().manual_seed(len(drawn))
        drawn.append(shape)
        return (torch.rand(shape, generator=g) < keep).to(device)

    def window(attrs):
        assert attrs.get("layout", "NCHW") == "NCHW"
        return (_pair(attrs["kernel"]), _pair(attrs.get("stride")),
                _pair(attrs.get("pad", (0, 0))))

    def is_relu(attrs):
        return attrs.get("act_type") == "relu"

    def is_max_window(attrs):
        return attrs.get("pool_type") == "max" \
            and not attrs.get("global_pool")

    def act_on_card(ctx, attrs, data):
        if is_relu(attrs):
            masks.append((data > 0).cpu())
        return act_fn(ctx, attrs, data)

    def act_with_card_mask(ctx, attrs, data):
        if not is_relu(attrs):
            return act_fn(ctx, attrs, data)
        mask = masks[len(flips["relu"]) % len(masks)]
        flips["relu"].append(int((mask != (data > 0)).sum()))
        return data.masked_fill(~mask, 0.0)

    def pool_on_card(ctx, attrs, data):
        if is_max_window(attrs):
            with torch.no_grad():
                argmax.append(F.max_pool2d(data, *window(attrs),
                                           return_indices=True)[1].cpu())
        return pool_fn(ctx, attrs, data)

    def pool_with_card_argmax(ctx, attrs, data):
        if not is_max_window(attrs):
            return pool_fn(ctx, attrs, data)
        idx = argmax[len(flips["max_pool"]) % len(argmax)]
        own = F.max_pool2d(data.detach(), *window(attrs),
                           return_indices=True)[1]
        flips["max_pool"].append(int((own != idx).sum()))
        return data.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    def record(name, fn):
        def on_card(ctx, attrs, *ins):
            outs = fn(ctx, attrs, *ins)
            replay[name]["card"].append(
                ([t.detach().cpu() for t in ins],
                 [t.detach().cpu() for t in outs]))
            return outs
        return on_card

    def replayed(name, fn, key, dtype):
        def with_card_outputs(ctx, attrs, *ins):
            replay[name][key].append([t.detach().cpu()
                                      for t in fn(ctx, attrs, *ins)])
            card = replay[name]["card"]
            outs = card[(len(replay[name][key]) - 1) % len(card)][1]
            return [o.to(dtype) if o.is_floating_point() else o
                    for o in outs]
        return with_card_outputs

    def install(fns, key=None, dtype=None):
        act.fn, pool.fn = fns
        for name, (op, fn) in shared.items():
            op.fn = record(name, fn) if key is None \
                else replayed(name, fn, key, dtype)

    def restore():
        act.fn, pool.fn = act_fn, pool_fn
        for op, fn in shared.values():
            op.fn = fn

    got = {}
    for name in replay:
        replay[name].update(card=[], cpu=[], f64=[])
    tnn.keep_mask = shared_mask
    try:
        for key, ctx, fns in (
                ("gpu", mx.gpu(0), (act_on_card, pool_on_card)),
                ("cpu", mx.cpu(), (act_with_card_mask,
                                   pool_with_card_argmax)),
                ("f64", None, (act_with_card_mask, pool_with_card_argmax))):
            t0 = time.perf_counter()
            drawn.clear()
            shared_key = None if key == "gpu" else key
            dtype = torch.float64 if ctx is None else torch.float32
            try:
                if ctx is None:
                    install(fns, shared_key, dtype)
                    outs, grads, aux, args = _f64_step(
                        mx, symbol, weights, x, y, optimizer, label)
                else:
                    mod = mx.mod.Module(symbol, context=ctx,
                                        label_names=(label,))
                    mod.bind(data_shapes=[("data", x.shape)],
                             label_shapes=[(label, y.shape)])
                    a, b = mx.convert.params_from_numpy(*weights, ctx)
                    mod.init_params(arg_params=a, aux_params=b)
                    mod.init_optimizer(optimizer=optimizer[0],
                                       optimizer_params=optimizer[1])
                    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx)],
                                            label=[mx.nd.array(y, ctx)])
                    install(fns, shared_key, dtype)
                    mod.forward(batch, is_train=True)
                    restore()
                    mod.backward()
                    outs = [o.asnumpy() for o in mod.get_outputs()]
                    grads = {n: g.asnumpy() for n, g in
                             mod._exec_group._executor.grad_dict.items()}
                    mod.update()
                    args, aux = mod.get_params()
                    args = {n: a.asnumpy() for n, a in args.items()}
                    aux = {n: a.asnumpy() for n, a in aux.items()}
                    del mod, batch
            finally:
                restore()
            got[key] = (outs, grads, aux, args, time.perf_counter() - t0)
    finally:
        tnn.keep_mask = keep_mask
    torch.cuda.empty_cache()
    gpu, cpu, f64 = got["gpu"], got["cpu"], got["f64"]
    nodes = symbol._nodes()
    n_relu = sum(1 for node in nodes
                 if node.op == "Activation" and is_relu(node.attrs))
    n_max = sum(1 for node in nodes
                if node.op == "Pooling" and is_max_window(node.attrs))
    n_shared = {name: sum(1 for node in nodes
                          if node.op and get_op(node.op) is op)
                for name, (op, _) in shared.items()}
    outputs, outputs_ok, outputs_msg = held(gpu[0], cpu[0])
    res = {"relu_masks_differ": [sum(flips["relu"][:n_relu]),
                                 sum(flips["relu"][n_relu:])],
           "max_pool_choices_differ": [sum(flips["max_pool"][:n_max]),
                                       sum(flips["max_pool"][n_max:])],
           "dropout_masks_shared": len(drawn),
           **outputs,
           "seconds": {k: v[4] for k, v in got.items()}}
    failed = []
    # a gradient that is exactly 0 (a convolution's bias before a
    # BatchNorm, which takes the mean out) is fp32 rounding noise on both
    # devices, and its gap over its own max-abs means nothing: it passes
    # when float64 gives it as 0 (1e-9 of the step's largest gradient) and
    # the card's is no larger than fp32 noise (1e-5 of that)
    scale = max(float(np.abs(g).max()) for g in f64[1].values())
    zeros = [n for n, g in f64[1].items()
             if float(np.abs(g).max()) <= 1e-9 * scale
             and float(np.abs(gpu[1][n]).max()) <= 1e-5 * scale]
    res["zero_gradients"] = zeros
    for i, (key, limit) in enumerate((("grad", 1e-3), ("aux", 1e-5),
                                      ("weight", 1e-5)), 1):
        gap = {n: _rel(gpu[i][n], cpu[i][n]) for n in cpu[i]
               if not (key == "grad" and n in zeros)}
        if not gap:
            continue
        worst = max(gap, key=gap.get)
        over = {n: {"card_vs_cpu": gap[n],
                    "card_vs_f64": _rel(gpu[i][n], f64[i][n]),
                    "cpu_vs_f64": _rel(cpu[i][n], f64[i][n])}
                for n in gap if gap[n] > limit}
        failed += [f"{key} {n}" for n, e in over.items()
                   if e["card_vs_f64"] > 2 * e["cpu_vs_f64"]]
        res[key] = {"limit": limit, "max_rel_err": gap[worst],
                    "worst": worst,
                    "median_rel_err": float(np.median(list(gap.values()))),
                    "over_limit": over}
    print(f"  card vs CPU, {what}: " + json.dumps(res), flush=True)
    check(len(flips["relu"]) == 2 * n_relu
          and len(flips["max_pool"]) == 2 * n_max
          and all(len(replay[name][k]) == n for name, n in n_shared.items()
                  for k in ("card", "cpu", "f64")),
          f"{what}: the CPU and float64 steps took the card's {n_relu} ReLU "
          f"masks, its {n_max} max-pool choices and the outputs of its "
          f"{n_shared} shared ops")
    check(outputs_ok, f"{what}: {outputs_msg}")
    check(not failed, f"{what}: every gradient array within 1e-3 of its "
          "max-abs (or exactly 0 in float64, and fp32 noise on the card), "
          "the moving statistics and updated weights within 1e-5, "
          "or the card no further from the float64 step than twice the CPU "
          f"(failed: {failed})")
    return res


def fit_card_vs_cpu_bf16(mx, seed):
    """An evaluation forward of ResNet-50 under bf16 amp at batch 8, 64 px,
    16 classes, the card against the CPU on identical weights: phase 8's
    log-probability limits (mean abs <= 5e-2, 99.9th percentile <= 0.25).

    The moving statistics are the batch's own, taken by one fp32 training
    forward on the card with every BatchNorm's momentum at 0: random ones
    leave the activations unnormalised, their scale doubling at each
    residual unit, and logits of that size round in bf16 by whole units of
    log-probability (0.36 mean abs, 7.0 at the 99.9th percentile, on the
    card and on the CPU alike)."""
    import torch

    symbol = resnet_symbol(mx, FIT_CPU_CLASSES, FIT_CPU_PX)
    args, aux = resnet_weights(symbol, FIT_CPU_BATCH, FIT_CPU_PX, seed + 21)
    calibrate = resnet_symbol(mx, FIT_CPU_CLASSES, FIT_CPU_PX)
    for node in calibrate._nodes():
        if node.op == "BatchNorm":
            node.attrs["momentum"] = 0.0
    mod = mx.mod.Module(calibrate, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (FIT_CPU_BATCH, 3, FIT_CPU_PX,
                                    FIT_CPU_PX))],
             label_shapes=[("softmax_label", (FIT_CPU_BATCH,))],
             for_training=False)
    mod.init_params(arg_params=mx.convert.params_from_numpy(
        args, {}, mx.gpu(0))[0], aux_params=mx.convert.params_from_numpy(
            {}, aux, mx.gpu(0))[1])
    mod.forward(_cpu_batch(mx, seed + 22, mx.gpu(0))[0], is_train=True)
    # (the executor's: get_params() refreshes only after an update)
    weights = (args, {n: a.asnumpy() for n, a in
                      mod._exec_group._executor.aux_dict.items()})
    del mod
    logp = {}
    for label, ctx, amp in (("gpu", mx.gpu(0), "bfloat16"),
                            ("cpu", mx.cpu(), "bfloat16"),
                            ("cpu_fp32", mx.cpu(), None)):
        mod = _small_resnet(mx, ctx, amp, False, weights)
        batch, _ = _cpu_batch(mx, seed + 22, ctx)
        mod.forward(batch, is_train=False)
        probs = mod.get_outputs()[0]
        check(probs.dtype == torch.float32, f"{label}: the eval forward "
              "gives fp32 probabilities")
        logp[label] = np.log(np.maximum(probs.asnumpy(), 1e-30))
        del mod
    err = np.abs(logp["gpu"] - logp["cpu"])
    res = {"logp_mean_abs_err": float(err.mean()),
           "logp_p999_abs_err": float(np.percentile(err, 99.9)),
           "argmax_agreement": float((logp["gpu"].argmax(1)
                                      == logp["cpu"].argmax(1)).mean()),
           # each bf16 forward's distance to the fp32 one
           "card_vs_fp32_mean_abs": float(np.abs(
               logp["gpu"] - logp["cpu_fp32"]).mean()),
           "cpu_vs_fp32_mean_abs": float(np.abs(
               logp["cpu"] - logp["cpu_fp32"]).mean())}
    print(f"  card vs CPU, bf16 eval forward at batch {FIT_CPU_BATCH}, "
          f"{FIT_CPU_PX} px: " + json.dumps(res), flush=True)
    # through 50 layers the two bf16 forwards round apart by about their
    # own distance to fp32: past phase 8's mean limit, the card passes when
    # it is no further from the fp32 forward than twice the CPU's bf16
    check(res["logp_mean_abs_err"] <= 5e-2
          or res["card_vs_fp32_mean_abs"]
          <= 2 * res["cpu_vs_fp32_mean_abs"],
          f"bf16 mean abs log-prob err {res['logp_mean_abs_err']:.3g} <= "
          "5e-2, or the card's distance to the fp32 forward "
          f"{res['card_vs_fp32_mean_abs']:.3g} <= twice the CPU's "
          f"{res['cpu_vs_fp32_mean_abs']:.3g}")
    check(res["logp_p999_abs_err"] <= 0.25, "bf16 99.9th percentile abs "
          f"log-prob err {res['logp_p999_abs_err']:.3g} <= 0.25")
    return res


def cifar_example():
    """``examples/train_cifar10.py`` at its defaults on the card: the
    reference's convergence gate, final validation accuracy >= 0.9."""
    from mxnet_tpu_torch.examples import train_cifar10

    t0 = time.perf_counter()
    acc = train_cifar10.main([])
    secs = time.perf_counter() - t0
    check(acc >= 0.9, f"train_cifar10 on the card: validation accuracy "
          f"{acc:.4f} >= 0.9 after 8 epochs ({secs:.1f} s)")
    return {"accuracy": acc, "seconds": secs}


# phase 11: ResNet-50 from a RecordIO file through the port's
# examples/image_classification/train_imagenet.py, at phase 10's config
REC_IMAGES, REC_CLASSES, REC_SHORT, REC_LONG = 3072, 1000, 256, 384
REC_QUALITY = 95
REC_BATCH, REC_PX = FIT_BATCH, FIT_PX
REC_SAME_BATCHES = 3   # the prefetch bit-identity run
# the resume check: the "Hot-loop parity" config, 6 batches, a checkpoint
# every 2, the first run stopped after batch 4
RESUME_BATCH, RESUME_PX, RESUME_BATCHES = FIT_CPU_BATCH, FIT_CPU_PX, 6
RESUME_EVERY, RESUME_STOP = 2, 4
# the convergence gate: 10 class prototypes at 40 px, ResNet-20 at 32 px
GATE_PX, GATE_TRAIN, GATE_VAL, GATE_CLASSES, GATE_EPOCHS = 40, 2048, 512, 10, 8
GATE_ARGS = ["--network", "resnet", "--num-layers", "20", "--image-shape",
             "3,32,32", "--num-classes", str(GATE_CLASSES), "--num-examples",
             str(GATE_TRAIN), "--batch-size", "128", "--lr", "0.05",
             "--lr-step-epochs", "30,60", "--num-epochs", str(GATE_EPOCHS),
             "--dtype", "float32", "--disp-batches", "8"]


def decode_pool_size():
    """P, the decode workers: the host's cores less the training loop's
    thread and the stager's."""
    return max(1, (os.cpu_count() or 1) - 2)


def _jpeg(arr, quality):
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def photo_like(rng, protos, label, grain, short, long):
    """One HWC uint8 image: the class's colour layout (a coarse grid,
    smoothly upsampled) mixed with a smooth random field of its own and a
    grain, so that it compresses like a photo. The shorter edge is
    ``short``, the longer one from ``short`` to ``long``."""
    from PIL import Image

    edge = int(rng.integers(short, long + 1))
    h, w = (short, edge) if rng.random() < 0.5 else (edge, short)
    base = np.asarray(Image.fromarray(protos[label]).resize(
        (w, h), Image.BICUBIC), np.float32)
    field = np.asarray(Image.fromarray(rng.integers(
        0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)).resize(
        (w, h), Image.BILINEAR), np.float32)
    y = rng.integers(0, grain.shape[0] - h + 1)
    x = rng.integers(0, grain.shape[1] - w + 1)
    img = 0.7 * base + 0.3 * field + grain[y:y + h, x:x + w]
    return np.clip(img, 0, 255).astype(np.uint8)


def pack_records(mx, prefix, labels, make_image, quality=REC_QUALITY):
    """``prefix.rec``/``.idx`` of one JPEG a label, ``make_image(i)`` made
    and encoded by a thread each core (PIL releases the interpreter lock
    while it encodes); returns the file's bytes."""
    from concurrent.futures import ThreadPoolExecutor

    def record(i):
        header = mx.recordio.IRHeader(0, float(labels[i]), i, 0)
        return mx.recordio.pack(header, _jpeg(make_image(i), quality))

    writer = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                           "w")
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for i, rec in enumerate(pool.map(record, range(len(labels)))):
            writer.write_idx(i, rec)
    writer.close()
    return os.path.getsize(prefix + ".rec")


def make_records(mx, tmp, seed):
    """The phase's two record files, made from ``seed``: 3072 photo-like
    images of 1000 classes, and the gate's class prototypes at 40 px."""
    rng = np.random.default_rng(seed + 30)
    protos = rng.integers(0, 256, (REC_CLASSES, 6, 8, 3), dtype=np.uint8)
    grain = rng.normal(0, 6, (REC_LONG, REC_LONG, 3)).astype(np.float32)
    labels = rng.integers(0, REC_CLASSES, REC_IMAGES)
    t0 = time.perf_counter()
    big = os.path.join(tmp, "train")
    nbytes = pack_records(mx, big, labels, lambda i: photo_like(
        np.random.default_rng([seed, i]), protos, labels[i], grain,
        REC_SHORT, REC_LONG))
    out = {"images": REC_IMAGES, "classes": REC_CLASSES,
           "rec_bytes": nbytes, "pack_s": time.perf_counter() - t0}
    g_protos = rng.integers(0, 256, (GATE_CLASSES, 4, 4, 3), dtype=np.uint8)

    def gate_image(label, i):
        from PIL import Image

        smooth = np.asarray(Image.fromarray(g_protos[label]).resize(
            (GATE_PX, GATE_PX), Image.BILINEAR), np.float32)
        noise = np.random.default_rng([seed, 7, i]).normal(
            0, 25, smooth.shape)
        return np.clip(smooth + noise, 0, 255).astype(np.uint8)

    gate = {}
    for name, n, off in (("gate_train", GATE_TRAIN, 0),
                         ("gate_val", GATE_VAL, GATE_TRAIN)):
        y = rng.integers(0, GATE_CLASSES, n)
        pack_records(mx, os.path.join(tmp, name), y,
                     lambda i, y=y, off=off: gate_image(y[i], off + i))
        gate[name] = os.path.join(tmp, name)
    print(f"  packed {REC_IMAGES} JPEGs (q{REC_QUALITY}, shorter edge "
          f"{REC_SHORT}, longer {REC_SHORT}-{REC_LONG}): {nbytes / 1e6:.1f} "
          f"MB in {out['pack_s']:.1f} s", flush=True)
    return big, gate, out


def rec_args(mx, rec, extra=()):
    """train_imagenet.py's arguments over ``rec`` at phase 10's config
    (its defaults: ResNet-50, 1000 classes, 224 px, batch 256, bf16, SGD lr
    0.1 momentum 0.9 wd 1e-4, random crop and mirror), one epoch."""
    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    return train_imagenet.parse_args(
        ["--data-train", rec + ".rec", "--num-examples", str(REC_IMAGES),
         "--batch-size", str(REC_BATCH), "--num-epochs", "1",
         "--disp-batches", "4", *extra])


def rec_iter(mx, rec, pool, shuffle=True, augment=True, parts=1):
    """An ImageIter over ``rec`` at the phase's batch and size: random crop
    and mirror when ``augment`` (else the centre), ``pool`` decode
    workers, the first of ``parts`` parts of the file."""
    return mx.image.ImageIter(
        batch_size=REC_BATCH, data_shape=(3, REC_PX, REC_PX),
        path_imgrec=rec + ".rec", path_imgidx=rec + ".idx", shuffle=shuffle,
        rand_crop=augment, rand_mirror=augment, preprocess_threads=pool,
        num_parts=parts)


def decode_rates(mx, rec, pool):
    """fit.py's ``--test-io`` pass over the file: images a second with
    ``preprocess_threads`` 0 and ``pool``; the pool's second pass has its
    workers up."""
    from mxnet_tpu_torch.examples.image_classification.common import fit

    out = {}
    for p in (0, pool):
        it = rec_iter(mx, rec, p)
        args = rec_args(mx, rec, ["--test-io", "1"])
        passes = []
        for _ in range(1 if p == 0 else 2):
            n, secs = fit.fit(args, None, lambda a, kv: (it, None))
            passes.append(n / secs)
            it.reset()
        it.close()
        out[f"threads_{p}"] = {"images_per_s": passes[-1],
                               "first_pass_images_per_s": passes[0]}
        print(f"  decode, preprocess_threads={p}: {passes[-1]:.0f} img/s "
              f"(first pass {passes[0]:.0f})", flush=True)
    return out


def trace_fit_step(mx, mod, source, metric, stager=None, ops=FIT_OPS,
                   ranges=FIT_RANGES, needed=("conv_fwd", "conv_bwd",
                                              "bn_fwd", "bn_bwd")):
    """One more training step of ``mod`` on the next batch of ``source``
    (an iterator, or a DevicePrefetchIter over one), traced into the groups
    of ``ranges`` (the ops of ``ops`` forward under a range of their group;
    each group of ``needed`` must run kernels), with the host's time by
    part: next batch,
    stage (the feed's copy to the card; with a ``stager``, its host time
    for this batch, on its own thread), forward+backward, update, metric.
    Returns the batch and the trace's numbers."""
    import torch

    from mxnet_tpu_torch import executor as texe
    from mxnet_tpu_torch.module import executor_group as tgroup

    host = {"stage": 0.0}

    def clock(key, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        host[key] = host.get(key, 0.0) + (time.perf_counter() - t) * 1e3
        return res

    def step():
        staged = stager.stage_seconds if stager is not None else 0.0
        batch = clock("next_batch", source.next)
        clock("forward_backward", mod.forward_backward, batch)
        with torch.profiler.record_function("chip_smoke::sgd_update"):
            clock("update", mod.update)
        clock("metric", mod.update_metric, metric, batch.label)
        if stager is not None:
            host["stage"] = (stager.stage_seconds - staged) * 1e3
        return batch

    saved = []
    for group, names in ops.items():
        saved += _wrap_ops(names, "chip_smoke::" + group)
    amp_cast, fed_tensor = texe._amp_cast, tgroup._fed_tensor

    def cast_traced(*a):
        with torch.profiler.record_function("chip_smoke::amp_cast"):
            return amp_cast(*a)

    texe._amp_cast = cast_traced
    tgroup._fed_tensor = lambda *a: clock("stage", fed_tensor, *a)
    traced = []
    try:
        by_name, groups = traced_groups(lambda: traced.append(timed(step)),
                                        ranges)
    finally:
        texe._amp_cast, tgroup._fed_tensor = amp_cast, fed_tensor
        for op, fn in saved:
            op.fn = fn
    (batch, host_ms), = traced
    check(by_name, "the profiler recorded device events for the step")
    busy = sum(by_name.values())
    split = {g: sum(t for k, t in ks if "Memcpy" not in k)
             for g, ks in groups.items()}
    split["h2d_copy"] = sum(t for k, t in by_name.items() if "HtoD" in k)
    split["d2h_copy"] = sum(t for k, t in by_name.items() if "DtoH" in k)
    split["rest"] = busy - sum(split.values())
    check(all(split[g] > 0 for g in needed),
          f"the traced step ran kernels in each of {needed}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return batch, {
        "host_ms": host_ms, "host_split_ms": host, "device_busy_ms": busy,
        "kernel_busy_ms": sum(t for k, t in by_name.items()
                              if "Memcpy" not in k),
        "split_ms": split,
        "copies_ms": {k: t for k, t in by_name.items() if "Mem" in k},
        "device_kernels": len(by_name),
        "top_kernels": [[k[:80], t] for k, t in top]}


def rec_fit(mx, rec, pool, prefetch, seed):
    """One epoch of train_imagenet.py's ``fit`` over ``rec`` (12 batches of
    256) with ``pool`` decode workers, with or without
    ``MXNET_DEVICE_PREFETCH=1``; the steady step, img/s, the stager's
    counters, then one traced step of the same pipeline."""
    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    it = rec_iter(mx, rec, pool)
    stamps, stager = [], []

    def stamp(p):
        stamps.append(time.perf_counter())
        stager[:] = [p.locals["train_data"]]

    os.environ["MXNET_DEVICE_PREFETCH"] = "1" if prefetch else "0"
    mx.random.seed(seed)
    t0 = time.perf_counter()
    try:
        mod = train_imagenet.main(
            ["--data-train", rec + ".rec", "--num-examples", str(REC_IMAGES),
             "--batch-size", str(REC_BATCH), "--num-epochs", "1",
             "--disp-batches", "4"],
            data_loader=lambda a, kv: (it, None),
            batch_end_callback=[stamp])
        secs = time.perf_counter() - t0
        return mod, _rec_fit_report(mx, mod, it, prefetch, pool, secs,
                                    stamps, stager)
    finally:
        os.environ.pop("MXNET_DEVICE_PREFETCH")
        it.close()


def _rec_fit_report(mx, mod, it, prefetch, pool, secs, stamps, stager):
    import torch

    steps = REC_IMAGES // REC_BATCH
    check(len(stamps) == steps, f"fit ran {len(stamps)} == {steps} batches "
          f"(prefetch {prefetch})")
    step_ms = list(np.diff(stamps) * 1e3)   # steps 2..n
    steady = float(np.median(step_ms[1:]))  # steps 3..n
    out = {"prefetch": prefetch, "threads": pool, "fit_s": secs,
           "step_ms": step_ms, "steady_step_ms": steady,
           "images_per_s": REC_BATCH / (steady / 1e3)}
    if prefetch:
        dp = stager[0]
        check(isinstance(dp, mx.io.DevicePrefetchIter),
              "fit armed a DevicePrefetchIter under MXNET_DEVICE_PREFETCH=1")
        # the stager also staged the next epoch's first batch before fit
        # closed it
        out.update(starved_count=dp.starved_count,
                   staged_count=dp.staged_count,
                   stage_ms_per_batch=dp.stage_seconds * 1e3
                   / dp.staged_count,
                   h2d_bytes_per_batch=dp.h2d_bytes / dp.staged_count)
    # the traced step: the same pipeline again, two batches in
    metric = mx.metric.create("acc")
    it.reset()
    dp = mod.device_prefetch(it) if prefetch else None
    source = it if dp is None else dp
    for _ in range(2):
        batch = source.next()
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
    # the restarted pool spends seconds starting its workers: trace a step
    # of the steady pipeline, its decode window done and the stager's queue
    # full
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 60 and not (
            all(f.done() for f, _ in it._pending or ())
            and (dp is None or dp._queue.full())):
        time.sleep(0.05)
    out["traced_step"] = trace_fit_step(mx, mod, source, metric, dp)[1]
    # the SMs' idle share: with prefetch the batch's copy runs on the copy
    # engine beside the step's kernels, so copies do not count as busy
    out["idle_share"] = 1.0 - out["traced_step"]["kernel_busy_ms"] / steady
    if dp is not None:
        dp.close()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  fit, prefetch {int(prefetch)}: steady {steady:.1f} ms, "
          f"{out['images_per_s']:.0f} img/s, idle {out['idle_share']:.3f}; "
          + json.dumps({k: v for k, v in out.items() if k != "step_ms"}),
          flush=True)
    return out


def h2d_copies(mx, batch):
    """The batch's H2D copy from pageable memory, from pinned memory, and
    the two ways to a pinned source: a host copy into a pinned buffer, or
    registering the host buffer with ``cudaHostRegister``."""
    import torch

    gpu = mx.gpu(0).torch_device
    host = batch.data[0].data.cpu().contiguous()
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(3):
        pinned.copy_(host)
    host_to_pinned = (time.perf_counter() - t0) / 3 * 1e3
    out = {"bytes": host.numel() * host.element_size(),
           "pageable_ms": time_cuda(lambda: host.to(gpu), reps=5, warmup=1),
           "pinned_ms": time_cuda(lambda: pinned.to(gpu, non_blocking=True),
                                  reps=5, warmup=1),
           "host_to_pinned_ms": host_to_pinned}
    cudart = torch.cuda.cudart()
    t0 = time.perf_counter()
    rc = cudart.cudaHostRegister(host.data_ptr(), out["bytes"], 0)
    out["host_register_ms"] = (time.perf_counter() - t0) * 1e3
    check(int(getattr(rc, "value", rc)) == 0,
          f"cudaHostRegister of the batch returned {rc}")
    try:
        out["registered_ms"] = time_cuda(
            lambda: host.to(gpu, non_blocking=True), reps=5, warmup=1)
    finally:
        torch.cuda.synchronize()
        cudart.cudaHostUnregister(host.data_ptr())
    print("  H2D of one batch: " + json.dumps(out), flush=True)
    return out


def prefetch_identity(mx, rec, pool, seed):
    """The same 3 batches (no shuffle, no random augmentation) through
    train_imagenet.py's ``fit`` without and with MXNET_DEVICE_PREFETCH=1,
    from one seed, with deterministic cuDNN: the parameters, aux states
    and the last outputs must be bit-identical."""
    import torch

    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    got = []
    try:
        for prefetch in (False, True):
            it = rec_iter(mx, rec, pool, shuffle=False, augment=False,
                          parts=REC_IMAGES // (REC_SAME_BATCHES * REC_BATCH))
            os.environ["MXNET_DEVICE_PREFETCH"] = "1" if prefetch else "0"
            mx.random.seed(seed + 40)
            try:
                mod = train_imagenet.main(
                    ["--data-train", rec + ".rec", "--num-examples",
                     str(REC_SAME_BATCHES * REC_BATCH), "--batch-size",
                     str(REC_BATCH), "--num-epochs", "1",
                     "--disp-batches", "4"],
                    data_loader=lambda a, kv, it=it: (it, None))
            finally:
                os.environ.pop("MXNET_DEVICE_PREFETCH")
                it.close()
            args, aux = mod.get_params()
            got.append(({n: a.asnumpy() for n, a in args.items()},
                        {n: a.asnumpy() for n, a in aux.items()},
                        mod.get_outputs()[0].asnumpy()))
            del mod
    finally:
        torch.backends.cudnn.deterministic = False
    (a0, x0, o0), (a1, x1, o1) = got
    diff = [n for n in a0 if not np.array_equal(a0[n], a1[n])] \
        + [n for n in x0 if not np.array_equal(x0[n], x1[n])]
    check(not diff and np.array_equal(o0, o1),
          f"{REC_SAME_BATCHES} batches with and without prefetch: all "
          f"{len(a0)} parameters, {len(x0)} aux states and the outputs "
          f"bit-identical (differ: {diff[:5]})")
    return {"batches": REC_SAME_BATCHES, "bit_identical": True}


class _Interrupt(Exception):
    pass


def resume_check(mx, rec, seed, tmp):
    """Run A: ``fit`` with a checkpoint every 2 batches, stopped after
    batch 4 by an exception in a batch-end callback, then ``resume=True``
    to batch 6; run B: 6 batches at once. The "Hot-loop parity" config
    (ResNet-50, batch 8, 64 px, fp32), serial decode, a seeded shuffle, no
    random augmentation, deterministic cuDNN. A resumes at the checkpoint's
    epoch and batch, and its weights and momenta equal B's (bit for bit,
    else within 1e-5 of max-abs)."""
    import random as pyrandom

    import torch

    gpu = mx.gpu(0)
    symbol = resnet_symbol(mx, REC_CLASSES, RESUME_PX)
    parts = REC_IMAGES // (RESUME_BATCH * RESUME_BATCHES)

    def run(prefix, stop=None, resume=False):
        pyrandom.seed(seed + 50)   # the shuffle
        it = mx.image.ImageIter(
            batch_size=RESUME_BATCH, data_shape=(3, RESUME_PX, RESUME_PX),
            path_imgrec=rec + ".rec", path_imgidx=rec + ".idx", shuffle=True,
            num_parts=parts, resize=RESUME_PX)
        mod = mx.mod.Module(symbol, context=gpu)
        seen = []

        def cb(p):
            seen.append((p.epoch, p.nbatch))
            if stop is not None and p.nbatch + 1 == stop:
                raise _Interrupt()

        mx.random.seed(seed + 50)
        try:
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params=FIT_SGD, initializer=mx.init.Xavier(
                        rnd_type="gaussian", factor_type="in", magnitude=2),
                    checkpoint_prefix=prefix,
                    checkpoint_every_n_batches=RESUME_EVERY if prefix
                    else None, resume=resume, batch_end_callback=cb)
        except _Interrupt:
            pass
        args, _ = mod.get_params()
        moms = {mod._param_names[i]: s.asnumpy()
                for i, s in mod._updater.states.items()}
        return {n: a.asnumpy() for n, a in args.items()}, moms, seen

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        prefix = os.path.join(tmp, "resume")
        _, _, seen_a1 = run(prefix, stop=RESUME_STOP)
        manifest = mx.model.read_manifest(prefix, 0)
        w_a, m_a, seen_a2 = run(prefix, resume=True)
        w_b, m_b, seen_b = run(None)
    finally:
        torch.backends.cudnn.deterministic = False
    check(manifest["batch"] == RESUME_STOP and manifest["epoch"] == 0,
          f"the checkpoint before the stop holds epoch 0, batch "
          f"{manifest['batch']}")
    check(seen_a1 == [(0, b) for b in range(RESUME_STOP)]
          and seen_a2 == [(0, b) for b in range(RESUME_STOP, RESUME_BATCHES)]
          and seen_b == [(0, b) for b in range(RESUME_BATCHES)],
          f"run A trained batches {seen_a1} then resumed at {seen_a2}")
    identical = all(np.array_equal(w_a[n], w_b[n]) for n in w_b) \
        and all(np.array_equal(m_a[n], m_b[n]) for n in m_b)
    worst = max(max(_rel(w_a[n], w_b[n]) for n in w_b),
                max(_rel(m_a[n], m_b[n]) for n in m_b))
    check(set(m_a) == set(m_b) and (identical or worst <= 1e-5),
          f"resumed weights and momenta equal the uninterrupted run's "
          f"(bit-identical {identical}, worst {worst:.3g} of max-abs)")
    return {"bit_identical": identical, "worst_rel": worst,
            "checkpoint": manifest}


def rec_gate(mx, gate):
    """train_imagenet.py on the gate's records (ResNet-20 at 32 px, random
    crop and mirror from 40 px, 8 epochs): validation accuracy >= 0.9."""
    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    t0 = time.perf_counter()
    mod = train_imagenet.main(GATE_ARGS + [
        "--data-train", gate["gate_train"] + ".rec",
        "--data-val", gate["gate_val"] + ".rec"])
    secs = time.perf_counter() - t0
    val = mx.image.ImageIter(batch_size=128, data_shape=(3, 32, 32),
                             path_imgrec=gate["gate_val"] + ".rec")
    acc = dict(mod.score(val, "acc"))["accuracy"]
    check(acc >= 0.9, f"train_imagenet.py on the record path: validation "
          f"accuracy {acc:.4f} >= 0.9 after {GATE_EPOCHS} epochs "
          f"({secs:.1f} s)")
    return {"accuracy": acc, "seconds": secs}


def phase_records(mx, seed, tmp):
    """ResNet-50 training from a RecordIO file through the port's
    train_imagenet.py: the data (written under ``tmp``, where phase 13
    reads it too), the decode rates, two full-width runs (without and with
    device prefetch), the copies, the prefetch bit-identity, resume, and
    the convergence gate."""
    import torch

    pool = decode_pool_size()
    route = mx.image.decode_route()
    print(f"phase 11: ResNet-{FIT_LAYERS} from a .rec through "
          f"train_imagenet.py (JPEG decode route {route!r}, "
          f"{pool} decode workers of {os.cpu_count()} cores)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    rec, gate, out = make_records(mx, tmp, seed)
    out.update(rec=rec, decode_route=route, decode_threads=pool,
               cpu_count=os.cpu_count())
    before = sum(mx.image.ROUTES.values())
    out["decode"] = decode_rates(mx, rec, pool)
    runs = []
    for prefetch in (False, True):
        mod, run = rec_fit(mx, rec, pool, prefetch, seed)
        runs.append(run)
        del mod
        torch.cuda.empty_cache()
    out["fit"] = runs
    it = rec_iter(mx, rec, 0, augment=False, parts=REC_IMAGES // REC_BATCH)
    out["h2d"] = h2d_copies(mx, it.next())
    it.close()
    out["prefetch_identity"] = prefetch_identity(mx, rec, pool, seed)
    out["resume"] = resume_check(mx, rec, seed, tmp)
    routes = dict(mx.image.ROUTES)
    check(sum(routes.values()) > before
          and routes.get(route, 0) == sum(routes.values()),
          f"every JPEG decoded through the {route!r} route: {routes}")
    out["decodes_by_route"] = routes
    out["gate"] = rec_gate(mx, gate)
    return out


# ------------------------------------------------------------ phase 12: PTB

# examples/rnn/lstm_bucketing.py's defaults, on the synthetic corpus at
# PTB's vocabulary: 2400 sentences over buckets 10-60 (about 12 batches of
# 32 a bucket), one epoch
PTB_VOCAB, PTB_SENTENCES, PTB_BATCH, PTB_HIDDEN, PTB_LAYERS = \
    10000, 2400, 32, 200, 2
PTB_TRACE_BUCKET = 60
# the traced step's device groups: each op's forward under a range of the
# script, each backward under the autograd engine's node
PTB_OPS = {
    "fc": ("FullyConnected",),
    "lstm_elementwise": ("Activation", "elemwise_add", "elemwise_mul",
                         "_plus_scalar", "SliceChannel", "Concat",
                         "expand_dims"),
    "cudnn_rnn": ("RNN",),
    "softmax_output": ("SoftmaxOutput",),
    "embedding": ("Embedding",),
}
PTB_RANGES = {
    "fc": ("chip_smoke::fc", _NODE + "AddmmBackward0",
           _NODE + "MmBackward0"),
    "lstm_elementwise": ("chip_smoke::lstm_elementwise",
                         _NODE + "SigmoidBackward0", _NODE + "TanhBackward0",
                         _NODE + "AddBackward0", _NODE + "AddBackward1",
                         _NODE + "MulBackward0", _NODE + "SplitBackward0",
                         _NODE + "CatBackward0", _NODE + "UnsqueezeBackward0"),
    "cudnn_rnn": ("chip_smoke::cudnn_rnn", _NODE + "_CudnnRnnBackward0"),
    "softmax_output": ("chip_smoke::softmax_output",
                       _NODE + "_SoftmaxOutputBackward"),
    "embedding": ("chip_smoke::embedding", _NODE + "IndexSelectBackward0",
                  _NODE + "WhereBackward0"),
    "update": ("chip_smoke::update",),
}
# card vs CPU (step 2) and the fused-vs-unrolled check (step 3)
PTB_SMALL = dict(num_hidden=32, num_embed=16, num_layers=2, vocab_size=50)
PTB_SMALL_BATCH, PTB_SMALL_BUCKETS = 4, (5, 8)
PTB_LIMITS = {"nll": 1e-5, "grad": 1e-4, "weight": 1e-5, "fused": 1e-5,
              # cuDNN's tanh RNN computes tanh about 2e-6 from float64 a
              # step (the step loop: 1e-7); over 60 steps and 2 layers at
              # hidden 200 its outputs read 1.0e-5 (1.3e-5 bidirectional)
              # from the loop and from a float64 run of it, where a wiring
              # fault (a bias, a gate order) reads 1e-2 and more
              "route_rnn_tanh": 3e-5}
PTB_GATE = dict(vocab=64, buckets=[8, 12, 16], hidden=64, embed=32,
                epochs=8, lr=3e-3, ppl=6.0)


def ptb_bind_timer(mx, binds):
    """Wrap ``BucketingModule.bind``/``switch_bucket`` so that each bucket's
    first use records its host ms (graph generation, shape inference, the
    executor's arrays) in ``binds``; returns what restores them."""
    import torch

    cls = mx.mod.BucketingModule
    bind, switch = cls.bind, cls.switch_bucket

    def timed_bind(self, *a, **k):
        t = time.perf_counter()
        bind(self, *a, **k)
        torch.cuda.synchronize()
        binds[self._default_bucket_key] = (time.perf_counter() - t) * 1e3

    def timed_switch(self, key, *a, **k):
        if key in self._buckets:
            return switch(self, key, *a, **k)
        t = time.perf_counter()
        switch(self, key, *a, **k)
        torch.cuda.synchronize()
        binds[key] = (time.perf_counter() - t) * 1e3

    cls.bind, cls.switch_bucket = timed_bind, timed_switch
    return lambda: (setattr(cls, "bind", bind),
                    setattr(cls, "switch_bucket", switch))


def ptb_traced_step(mx, model, data_train, bucket):
    """Two more training steps of ``model`` on ``bucket`` batches: the
    first with the host's time by part (next batch, the forward walk
    ``Executor._walk``, autograd's backward inside the training forward,
    the rest of the forward, the grad writes of ``backward``, the update
    and the metric), the second traced into ``PTB_RANGES``' groups (the
    profiler slows the host, so the parts come from the untraced step)."""
    import torch

    from mxnet_tpu_torch import executor as texe

    host = {}

    def clocked(key, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] = host.get(key, 0.0) \
                    + (time.perf_counter() - t) * 1e3
        return wrapped

    # the batches' places in the epoch, so that next() gives them
    data_train.reset()
    places = [i for i, (b, _) in enumerate(data_train.idx)
              if data_train.buckets[b] == bucket]
    metric = mx.metric.Perplexity(0)

    def step(place, part):
        data_train.curr_idx = place
        batch = part("next_batch", data_train.next)()
        part("forward", model.forward)(batch, is_train=True)
        part("backward", model.backward)()
        with torch.profiler.record_function("chip_smoke::update"):
            part("update", model.update)()
        part("metric", model.update_metric)(metric, batch.label)
        return batch

    walk, grad = texe.Executor._walk, torch.autograd.grad
    texe.Executor._walk = clocked("forward_walk", walk)
    torch.autograd.grad = clocked("autograd_backward", grad)
    try:
        host_step_ms = timed(lambda: step(places[0], clocked))[1]
    finally:
        texe.Executor._walk, torch.autograd.grad = walk, grad
    saved = []
    for group, names in PTB_OPS.items():
        saved += _wrap_ops(names, "chip_smoke::" + group)
    traced, counts = [], {}
    try:
        by_name, groups = traced_groups(
            lambda: traced.append(timed(lambda: step(
                places[1], lambda key, fn: fn))), PTB_RANGES, counts)
    finally:
        for op, fn in saved:
            op.fn = fn
    (batch, host_ms), = traced
    check(by_name, "the profiler recorded device events for the step")
    check(batch.bucket_key == bucket, f"the traced batch is bucket {bucket}")
    kernels = {k: t for k, t in by_name.items() if "Memcpy" not in k
               and "Memset" not in k}
    busy = sum(kernels.values())
    split = {g: sum(t for k, t in ks if k in kernels)
             for g, ks in groups.items()}
    split["rest"] = busy - sum(split.values())
    # the forward's feed, bucket switch and grad bookkeeping
    host["forward_other"] = host.pop("forward") - host["forward_walk"] \
        - host["autograd_backward"]
    rest = dict(kernels)
    for ks in groups.values():
        for k, t in ks:
            if k in rest:
                rest[k] -= t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"host_ms": host_step_ms, "host_split_ms": host,
            "traced_host_ms": host_ms,
            "rest_top_kernels": [[k[:80], t] for k, t in sorted(
                rest.items(), key=lambda kv: -kv[1])[:8]],
            "kernel_busy_ms": busy, "split_ms": split,
            "kernel_launches": sum(n for k, n in counts.items()
                                   if k in kernels),
            "copies_ms": {k: t for k, t in by_name.items() if "Mem" in k},
            "perplexity": metric.get()[1],
            "top_kernels": [[k[:80], t] for k, t in top]}


def ptb_run(mx, fused, seed, keep):
    """The port's lstm_bucketing.py at its defaults for one epoch of the
    synthetic corpus at PTB's vocabulary; per-bucket steady step ms, bind
    ms, tokens/s, peak memory, and one traced bucket-60 step. ``keep[fused]``
    gets the weights after the epoch."""
    import torch

    from mxnet_tpu_torch.examples.rnn import lstm_bucketing
    from mxnet_tpu_torch.ops import rnn_op

    torch.cuda.reset_peak_memory_stats()
    rnn_op.reset_launches()
    binds, stamps = {}, []

    def stamp(p):
        b = p.locals["data_batch"]
        lbl = b.label[0].asnumpy()
        stamps.append((b.bucket_key, time.perf_counter(),
                       int((lbl != lstm_bucketing.INVALID_LABEL).sum()),
                       int(lbl.size)))

    restore = ptb_bind_timer(mx, binds)
    t0 = time.perf_counter()
    try:
        model, data_train, _ = _ptb_main(mx, fused, seed, stamp)
    finally:
        restore()
    fit_s = time.perf_counter() - t0
    # the weights after the epoch, which phase 13 holds its steps to
    keep[fused] = [a.cpu().numpy() for a in _bucket_arrays(model)]
    cudnn_fit = rnn_op.cudnn_calls
    n_steps = len(stamps)
    check(n_steps == len(data_train.idx)
          and {s[0] for s in stamps} == set(lstm_bucketing.BUCKETS),
          f"one epoch of {n_steps} batches over buckets "
          f"{sorted({s[0] for s in stamps})}")
    # step i runs between callbacks i-1 and i; a bucket's first step binds
    seen, by_bucket = set(), {}
    steady_tok = steady_pos = steady_s = 0.0
    for prev, cur in zip(stamps, stamps[1:]):
        key, dt = cur[0], cur[1] - prev[1]
        if key not in seen:
            seen.add(key)
            continue
        by_bucket.setdefault(key, []).append(dt * 1e3)
        steady_tok += cur[2]
        steady_pos += cur[3]
        steady_s += dt
    steady = {k: float(np.median(v)) for k, v in sorted(by_bucket.items())}
    ppl = dict(model.score(data_train, mx.metric.Perplexity(0),
                           num_batch=4))["Perplexity"]
    out = {"fused": bool(fused), "steps": n_steps, "fit_s": fit_s,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "steady_step_ms_by_bucket": steady,
           "steady_steps_by_bucket": {k: len(v)
                                      for k, v in sorted(by_bucket.items())},
           "bind_ms_by_bucket": {k: binds[k] for k in sorted(binds)},
           "tokens_per_s": steady_tok / steady_s,
           "padded_positions_per_s": steady_pos / steady_s,
           "epoch_tokens_per_s": sum(s[2] for s in stamps) / fit_s,
           "train_perplexity_4_batches": ppl,
           "cudnn_calls_fit": cudnn_fit,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(np.isfinite(ppl) and 0.5 * PTB_VOCAB < ppl < 2 * PTB_VOCAB,
          f"perplexity {ppl:.1f} finite and near the vocabulary "
          f"({PTB_VOCAB}) on a corpus of uniform random tokens")
    if fused:
        check(cudnn_fit >= n_steps, f"cuDNN's RNN ran {cudnn_fit} times in "
              f"the epoch's {n_steps} training steps and its evaluation")
    else:
        check(cudnn_fit == 0, "the unrolled cells ran no fused RNN")
    rnn_op.reset_launches()
    traced = ptb_traced_step(mx, model, data_train, PTB_TRACE_BUCKET)
    traced["cudnn_calls"] = rnn_op.cudnn_calls
    traced["idle_share"] = 1.0 - traced["kernel_busy_ms"] \
        / steady[PTB_TRACE_BUCKET]
    traced["host_us_per_launch"] = traced["host_ms"] * 1e3 \
        / max(1, traced["kernel_launches"])
    if fused:
        check(traced["cudnn_calls"] == 2 and traced["split_ms"]["cudnn_rnn"]
              > 0, "the two steps ran cuDNN's RNN once each")
    else:
        check(traced["split_ms"]["lstm_elementwise"] > 0,
              "the traced step ran the cells' elementwise ops")
    check(np.isfinite(traced["perplexity"]), "the traced step's perplexity "
          "finite")
    # the copy the metric would make without its gather on the device:
    # the bucket-60 batch's whole (batch * T, V) output to the host
    pred = model.get_outputs()[0]
    traced["full_output_copy_ms"] = timed(pred.asnumpy)[1]
    traced["full_output_mb"] = pred.size * 4 / 1e6
    out["traced_step"] = traced
    print("  " + json.dumps({k: v for k, v in out.items()
                             if k != "traced_step"}), flush=True)
    print("  traced step: " + json.dumps(traced), flush=True)
    return out


def _ptb_small_batches(mx, seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in PTB_SMALL_BUCKETS:
        x = rng.integers(1, PTB_SMALL["vocab_size"],
                         (PTB_SMALL_BATCH, t)).astype(np.float32)
        y = np.roll(x, -1, axis=1)
        y[:, -1] = 0
        out.append((t, x, y))
    return out


def ptb_card_vs_cpu(mx, seed):
    """One SGD step a bucket (5, then 8) of each variant at a small width,
    on the card and on the CPU from the same weights and batches: NLL,
    gradients and the updated weights."""
    res = {}
    for fused in (False, True):
        factory = (mx.models.lstm_lm.fused_sym_gen_factory if fused
                   else mx.models.lstm_lm.sym_gen_factory)(**PTB_SMALL)
        big = max(PTB_SMALL_BUCKETS)
        sym = factory(big)[0]
        shapes = {"data": (PTB_SMALL_BATCH, big),
                  "softmax_label": (PTB_SMALL_BATCH, big)}
        rng = np.random.default_rng(seed + 30)
        weights = {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
                   for n, s in zip(sym.list_arguments(),
                                   sym.infer_shape(**shapes)[0])
                   if n not in shapes}
        runs = {}
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            mod = mx.mod.BucketingModule(factory, default_bucket_key=big,
                                         context=ctx)
            mod.bind([mx.io.DataDesc("data", shapes["data"])],
                     [mx.io.DataDesc("softmax_label",
                                     shapes["softmax_label"])])
            mod.init_params(arg_params={n: mx.nd.array(w, ctx)
                                        for n, w in weights.items()})
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9})
            steps = []
            for t, x, y in _ptb_small_batches(mx, seed + 31):
                cpu = mx.cpu()
                mod.forward(mx.io.DataBatch(
                    [mx.nd.array(x, cpu)], [mx.nd.array(y, cpu)],
                    bucket_key=t,
                    provide_data=[mx.io.DataDesc("data", x.shape)],
                    provide_label=[mx.io.DataDesc("softmax_label", y.shape)]),
                    is_train=True)
                mod.backward()
                probs = mod.get_outputs()[0].asnumpy()
                lab = y.reshape(-1).astype(int)
                nll = float(-np.log(probs[np.arange(lab.size), lab]).mean())
                ex = mod._curr_module._exec_group._executor
                steps.append((nll, {n: ex.grad_dict[n].asnumpy()
                                    for n in weights}))
                mod.update()
            args, _ = mod.get_params()
            runs[where] = (steps, {n: args[n].asnumpy() for n in weights})
        card, cpu = runs["card"], runs["cpu"]
        gap = {"nll": max(abs(a[0] - b[0]) for a, b in zip(card[0], cpu[0])),
               "grad": max(float(np.abs(a[1][n] - b[1][n]).max()
                                 / max(np.abs(b[1][n]).max(), 1e-30))
                           for a, b in zip(card[0], cpu[0]) for n in weights),
               "weight": max(float(np.abs(card[1][n] - cpu[1][n]).max())
                             for n in weights)}
        name = "fused" if fused else "unrolled"
        for k in ("nll", "grad", "weight"):
            check(gap[k] <= PTB_LIMITS[k], f"{name}, card vs CPU {k} gap "
                  f"{gap[k]:.2e} <= {PTB_LIMITS[k]}")
        res[name] = gap
    return res


def _rnn_case(device, mode, layers, bi, t, n, c, h, seed):
    import torch

    from mxnet_tpu_torch.ops import rnn_op

    g = torch.Generator(device=device).manual_seed(seed)
    d = 2 if bi else 1

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    # the flat vector from the initializer's ``_parameters`` rule,
    # U(-0.07, 0.07), the distribution the op trains from
    size = rnn_op.rnn_param_size(mode, layers, c, h, bi)
    params = (torch.rand(size, generator=g, device=device) - 0.5) * 0.14
    ins = [rand(t, n, c), params, rand(layers * d, n, h, scale=0.5)]
    if mode == "lstm":
        ins.append(rand(layers * d, n, h, scale=0.5))
    return {"mode": mode, "num_layers": layers, "state_size": h,
            "bidirectional": bi, "state_outputs": True}, ins


def _rnn_fwd_bwd(attrs, ins, plain, heads=None):
    import torch

    from mxnet_tpu_torch.ops import rnn_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    leaves = [x.detach().requires_grad_() for x in ins]
    outs = rnn_op.rnn_forward(OpCtx(is_train=True, device=ins[0].device),
                              attrs, *leaves, plain=plain)
    if heads is None:
        heads = [torch.ones_like(o) for o in outs]
    grads = torch.autograd.grad(outs, leaves, heads)
    return [o.detach() for o in outs] + list(grads)


def ptb_fused_vs_unrolled(mx, seed):
    """The fused op against the unrolled cells at bucket 60, hidden 200
    (weights packed, 1.0 added to the forget bias), inference; the fused
    op's cuDNN route against its plain route for each mode and
    bidirectional, outputs and gradients; and the cuDNN forward+backward
    timed at the main path's shape beside the plain route."""
    import torch

    from mxnet_tpu_torch.ops import rnn_op

    t, n, h, layers = PTB_TRACE_BUCKET, PTB_BATCH, PTB_HIDDEN, PTB_LAYERS
    rng = np.random.default_rng(seed + 40)
    stack = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mx.rnn.LSTMCell(h, prefix=f"lstm_l{i}_"))
    unrolled, _ = stack.unroll(t, inputs=mx.sym.Variable("data"),
                               layout="TNC", merge_outputs=True)
    shapes = dict(zip(unrolled.list_arguments(), unrolled.infer_shape(
        data=(t, n, h), __batch_size__=(n,))[0]))
    arrays = {k: (rng.standard_normal(s) * (1.0 if k == "data" else 0.1))
              .astype(np.float32) for k, s in shapes.items()}
    flat, hs, cs = [], [], []
    for i in range(layers):
        b_ih = arrays[f"lstm_l{i}_i2h_bias"].copy()
        b_ih[h:2 * h] += 1.0
        flat += [arrays[f"lstm_l{i}_i2h_weight"].ravel(),
                 arrays[f"lstm_l{i}_h2h_weight"].ravel(), b_ih,
                 arrays[f"lstm_l{i}_h2h_bias"]]
        hs.append(arrays[f"lstm_l{i}_begin_state_0"])
        cs.append(arrays[f"lstm_l{i}_begin_state_1"])
    gpu = mx.gpu(0)
    got_u = unrolled.bind(gpu, {k: mx.nd.array(a, gpu)
                                for k, a in arrays.items()}).forward()[0]
    fused = mx.sym.RNN(mx.sym.Variable("data"), mx.sym.Variable("p"),
                       mx.sym.Variable("s"), mx.sym.Variable("sc"),
                       state_size=h, num_layers=layers, mode="lstm")
    rnn_op.reset_launches()
    got_f = fused.bind(gpu, {
        "data": mx.nd.array(arrays["data"], gpu),
        "p": mx.nd.array(np.concatenate(flat), gpu),
        "s": mx.nd.array(np.stack(hs), gpu),
        "sc": mx.nd.array(np.stack(cs), gpu)}).forward()[0]
    check(rnn_op.cudnn_calls == 1, "the fused op ran cuDNN")
    gap = float((got_f.data - got_u.data).abs().max())
    check(gap <= PTB_LIMITS["fused"], f"fused (cuDNN) vs unrolled cells at "
          f"T {t}, N {n}, hidden {h}: {gap:.2e} <= {PTB_LIMITS['fused']}")
    out = {"fused_vs_unrolled": gap, "routes": {}}
    for mode, bi in (("lstm", False), ("gru", False), ("rnn_tanh", False),
                     ("rnn_relu", False), ("lstm", True), ("gru", True),
                     ("rnn_tanh", True)):
        attrs, ins = _rnn_case(gpu.torch_device, mode, layers, bi, t, n, h,
                               h, seed + 41)
        cud = _rnn_fwd_bwd(attrs, ins, None)
        plain = _rnn_fwd_bwd(attrs, ins, True)
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(cud, plain))
        name = mode + ("_bidirectional" if bi else "")
        limit = PTB_LIMITS.get("route_" + mode, PTB_LIMITS["fused"])
        check(err <= limit, f"cuDNN route vs plain, {name}, outputs and "
              f"gradients: {err:.2e} <= {limit}")
        out["routes"][name] = err
    # the main path's fused RNN (2 layers, T 60, N 32, 200 -> 200):
    # forward and backward
    attrs, ins = _rnn_case(gpu.torch_device, "lstm", layers, False, t, n, h,
                           h, seed + 42)
    attrs["state_outputs"] = False
    heads = [torch.ones((t, n, h), device=gpu.torch_device)]
    ms = time_cuda(lambda: _rnn_fwd_bwd(attrs, ins, None, heads))
    # the call waits on the device inside (time_device cannot queue it):
    # the profiler's device time of one call, every kernel counted
    device_ms = device_busy_ms(lambda: _rnn_fwd_bwd(attrs, ins, None, heads))
    plain_ms = time_cuda(lambda: _rnn_fwd_bwd(attrs, ins, True, heads),
                         reps=3, warmup=1)
    # forward 2*T*N*4H*(C+H) a layer, backward twice that; bytes: the
    # parameters, data, states and output read or written once each way
    flops = 3 * layers * 2.0 * t * n * 4 * h * (h + h)
    nbytes = 4.0 * (2 * ins[1].numel() + 2 * t * n * h * 2
                    + 4 * layers * n * h)
    bound, by = bytes_bound(nbytes, flops)
    out["cudnn_fwd_bwd"] = {"ms": ms, "device_busy_ms": device_ms,
                            "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": by, "shape": [t, n, h, h, layers]}
    # where cuDNN keeps each [W_ih, W_hh, b_ih, b_hh] block of the op's
    # flat vector at this shape, and the gather's time when they move
    flat = ins[1]
    idx = rnn_op._cudnn_layout("lstm", flat.device, h, h, layers, False,
                               flat.numel())
    starts, off = [], 0
    for layer in range(layers):
        for size in (4 * h * h, 4 * h * h, 4 * h, 4 * h):
            starts.append(off if idx is None else
                          int((idx == off).nonzero()[0, 0]))
            off += size
    out["cudnn_layout"] = {
        "flat_vector_as_is": idx is None, "block_starts": starts,
        "gather_ms": None if idx is None else time_cuda(
            lambda: torch.cat([flat, flat.new_zeros(1)])[idx])}
    print("  fused vs unrolled: " + json.dumps(out), flush=True)
    return out


def ptb_dropout(mx, seed):
    """Per-node masks on the card at (4096, 1024): two Dropout nodes of
    equal shape draw different masks; a node before them that draws (in
    place of one that does not) leaves them as they were; the kept share
    is within 4 sigma of 1 - p; backward(out_grads) reproduces the masks."""
    import torch

    shape, p = (4096, 1024), 0.5
    gpu = mx.gpu(0)

    def pair(first_random):
        first = (mx.sym.uniform(shape=(2, 2), name="first") if first_random
                 else mx.sym._zeros(shape=(2, 2), name="first"))
        x = mx.sym.Variable("x")
        net = mx.sym.Group([first, mx.sym.Dropout(x, p=p, name="da"),
                            mx.sym.Dropout(x, p=p, name="db")])
        ex = net.bind(gpu, {"x": mx.nd.ones(shape, gpu)},
                      args_grad={"x": mx.nd.zeros(shape, gpu)})
        mx.random.seed(seed)
        outs = ex.forward(is_train=True)
        return outs[1].data, outs[2].data, ex

    a, b, ex = pair(False)
    a2, b2, _ = pair(True)
    differ = float((a != b).float().mean())
    check(differ > 0.4, f"two Dropout nodes draw different masks "
          f"({differ:.3f} of entries differ)")
    check(bool(torch.equal(a, a2) and torch.equal(b, b2)),
          "their masks do not change when a node before them draws")
    kept = float((a != 0).float().mean())
    sigma = np.sqrt(p * (1 - p) / a.numel())
    check(abs(kept - (1 - p)) < 4 * sigma, f"kept share {kept:.5f} within "
          f"4 sigma ({4 * sigma:.5f}) of {1 - p}")
    ex.backward([mx.nd.zeros((2, 2), gpu), mx.nd.ones(shape, gpu),
                 mx.nd.zeros(shape, gpu)])
    check(bool(torch.equal(ex.grad_dict["x"].data, a)),
          "backward(out_grads) reproduces the forward's mask")
    return {"differ_share": differ, "kept_share": kept, "sigma": sigma}


def _gate_corpus(n, rng):
    sents = []
    for _ in range(n):
        x = int(rng.randint(1, 62))
        s = [x]
        for _ in range(int(rng.choice(PTB_GATE["buckets"])) - 1):
            x = (3 * x + 7) % 61 + 1
            s.append(x)
        sents.append(s)
    return sents


def ptb_gate(mx, fused):
    """tests/test_lstm_bucketing.py's convergence gate through the port's
    BucketingModule on the card."""
    rng = np.random.RandomState(7)
    train, val = _gate_corpus(600, rng), _gate_corpus(100, rng)
    g = PTB_GATE
    it = mx.rnn.BucketSentenceIter(train, 32, buckets=g["buckets"],
                                   invalid_label=0)
    iv = mx.rnn.BucketSentenceIter(val, 32, buckets=g["buckets"],
                                   invalid_label=0)
    factory = (mx.models.lstm_lm.fused_sym_gen_factory if fused
               else mx.models.lstm_lm.sym_gen_factory)
    mod = mx.mod.BucketingModule(
        factory(num_hidden=g["hidden"], num_embed=g["embed"], num_layers=1,
                vocab_size=g["vocab"]),
        default_bucket_key=it.default_bucket_key, context=mx.gpu(0))
    t0 = time.perf_counter()
    mod.fit(it, eval_data=iv, eval_metric=mx.metric.Perplexity(0),
            optimizer="adam", optimizer_params={"learning_rate": g["lr"]},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=g["epochs"])
    ppl = dict(mod.score(iv, mx.metric.Perplexity(0)))["Perplexity"]
    name = "fused" if fused else "unrolled"
    check(np.isfinite(ppl) and ppl < g["ppl"], f"convergence gate, {name}: "
          f"validation perplexity {ppl:.3f} < {g['ppl']}")
    return {"perplexity": ppl, "seconds": time.perf_counter() - t0}


def phase_ptb(mx, seed, keep):
    """The LSTM-PTB slice: the port's lstm_bucketing.py at its defaults
    (unrolled and fused), card vs CPU, fused vs unrolled and cuDNN vs the
    plain route, per-node Dropout, and the convergence gate; ``keep`` gets
    each variant's weights after the epoch."""
    import torch

    print(f"phase 12: LSTM-PTB through BucketingModule (lstm_bucketing.py "
          f"defaults: {PTB_LAYERS} x {PTB_HIDDEN}, batch {PTB_BATCH}, "
          f"buckets 10-60; vocab {PTB_VOCAB}, {PTB_SENTENCES} synthetic "
          f"sentences, 1 epoch; TF32 cudnn="
          f"{torch.backends.cudnn.allow_tf32} matmul="
          f"{torch.backends.cuda.matmul.allow_tf32})", flush=True)
    out = {}
    for fused in (False, True):
        out["fused" if fused else "unrolled"] = ptb_run(mx, fused, seed,
                                                        keep)
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = ptb_card_vs_cpu(mx, seed)
    out["fused_vs_unrolled"] = ptb_fused_vs_unrolled(mx, seed)
    out["dropout"] = ptb_dropout(mx, seed)
    out["gate"] = {("fused" if f else "unrolled"): ptb_gate(mx, f)
                   for f in (False, True)}
    return out


# ------------------------------------------------ phase 13: the one-program step

# the comparison runs of (b): steps from one start, deterministic cuDNN
GRAPH_FIT_STEPS = 4
GRAPH_LM_STEPS = 6          # (c): phase 9's step count plus one
GRAPH_LM_TIMED = 4          # (c): replays timed alone after them
GRAPH_REC_EPOCHS = 2        # (b): epochs of train_imagenet.py a run
# where two eager runs differ, the captured run is held to the phase's
# card-vs-CPU limits (of each array's max-abs; the NLL relative): phase
# 9's NLL and gradients, phase 10's and 12's weights
GRAPH_NLL_LIMIT = 1e-4
# (c) under bf16 amp every gradient is a bf16 value; where two eager runs
# part (the embedding's bf16 scatter-add sums a repeated id's rows in any
# order), one bf16 ulp of the array's largest element: 2^-7 of its max-abs
GRAPH_BF16_GRAD_LIMIT = 2.0 ** -7
GRAPH_WEIGHT_LIMIT = 1e-5
# the reference's fused-vs-split limits (tests/test_fused_step.py:55-58)
GRAPH_SPLIT_RTOL, GRAPH_SPLIT_ATOL = 2e-4, 2e-5


class eager_steps:
    """While open, every fused step built runs its function eagerly on the
    card (the reference the captured steps are held to)."""

    def __enter__(self):
        from mxnet_tpu_torch.module import step_graph

        self._init = init = step_graph.StepProgram.__init__

        def eager_init(prog, *a, **k):
            init(prog, *a, **k)
            prog.capturable = False

        step_graph.StepProgram.__init__ = eager_init
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.module import step_graph

        step_graph.StepProgram.__init__ = self._init


def _module_arrays(mod):
    """Copies of a module's parameters, aux states and optimizer states on
    the card, in a fixed order."""
    args, aux = mod.get_params()
    out = [args[k].data.clone() for k in sorted(args)]
    out += [aux[k].data.clone() for k in sorted(aux)]
    for i in sorted(mod._updater.states):
        out += [t.clone() for t in
                mod._optimizer._state_leaves(mod._updater.states[i])]
    return out


def _max_rel(got, want):
    """The largest gap of two lists of tensors, each over its want's
    max-abs (at least 1)."""
    return max(float((a.float() - b.float()).abs().max())
               / max(1.0, float(b.float().abs().max()))
               for a, b in zip(got, want))


def hold_to_eager(what, captured, eager1, eager2, limits):
    """The captured run against the eager function's from the same start;
    each run is a dict of parts (lists of tensors). Bit-identical where the
    two eager runs are, else each part of ``limits`` within its limit of
    each array's max-abs (at least 1)."""
    import torch

    def same(a, b):
        return all(len(a[k]) == len(b[k]) and all(
            torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a)

    exact, bit = same(eager1, eager2), same(captured, eager1)
    errs = {k: 0.0 if bit else _max_rel(captured[k], eager1[k])
            for k in captured}
    spread = {k: _max_rel(eager2[k], eager1[k]) for k in captured}
    if exact:
        check(bit, f"{what}: the captured steps bit-identical to the eager "
              f"function's (two eager runs are; gaps {errs})")
    else:
        check(all(errs[k] <= lim for k, lim in limits.items()),
              f"{what}: captured vs eager {errs} within {limits} (two eager "
              f"runs differ by {spread})")
    return {"eager_runs_bit_identical": exact,
            "captured_bit_identical": bit, "max_rel_err": errs,
            "eager_spread": spread}


def graph_step_probe(mx, model, batch, steady_ms):
    """Two priming steps of ``model`` on ``batch`` (a warm-up and a capture
    where the step was built anew), then one step whose issue the host
    times (forward, backward and update return before the card is done),
    one between two CUDA events, and one under the profiler: kernels a
    step, kernel busy ms, the idle share against ``steady_ms``."""
    import torch

    def step():
        model.forward(batch, is_train=True)
        model.backward()
        model.update()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    counts, spans = {}, []
    by_name, _ = traced_groups(step, {}, counts, spans)
    kernels = {k: t for k, t in by_name.items()
               if "Memcpy" not in k and "Memset" not in k}
    # cuDNN's RNN kernels: elemWiseRNNcell, LSTM_elementWise_*, RNN_*
    rnn = sum(counts[k] for k in kernels if "RNN" in k or "LSTM" in k)
    # kernels of a graph may run side by side: busy is the time covered by
    # at least one kernel, beside their summed time
    busy, end_us = 0.0, None
    for s0, s1 in sorted(spans):
        if end_us is None or s0 > end_us:
            busy += s1 - s0
            end_us = s1
        elif s1 > end_us:
            busy += s1 - end_us
            end_us = s1
    busy /= 1e3
    return {"host_issue_ms": host_ms, "step_wall_ms": wall_ms,
            "event_ms": start.elapsed_time(end),
            "kernels": sum(counts[k] for k in kernels),
            "rnn_kernels": rnn,
            "kernel_sum_ms": sum(kernels.values()),
            "kernel_busy_ms": busy,
            "idle_share": 1.0 - busy / steady_ms if busy else None,
            "copies_ms": {k: t for k, t in by_name.items() if "Mem" in k}}


def _memory():
    import torch

    return {"peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def _ptb_main(mx, fused, seed, callback=None):
    """lstm_bucketing.py at phase 12's arguments from one start: the
    corpus, its shuffles and the initial weights seeded."""
    import random

    from mxnet_tpu_torch.examples.rnn import lstm_bucketing

    random.seed(seed)
    np.random.seed(seed)
    mx.random.seed(seed)
    return lstm_bucketing.main(
        ["--num-epochs", "1", "--vocab-size", str(PTB_VOCAB),
         "--num-sentences", str(PTB_SENTENCES), "--seed", str(seed),
         "--fused-rnn", str(int(fused)), "--disp-batches", "24"],
        batch_end_callback=[callback] if callback else [])


def _bucket_arrays(model):
    args, _ = model.get_params()
    return [args[k].data.clone() for k in sorted(args)]


def graph_ptb(mx, fused, seed, split_weights):
    """(a) one epoch of lstm_bucketing.py at its defaults with the captured
    step: steady ms and tokens/s by bucket, each bucket's graph, a probe
    step a bucket; held to two eager runs and to phase 12's split run."""
    import torch

    from mxnet_tpu_torch.examples.rnn import lstm_bucketing
    from mxnet_tpu_torch.ops import rnn_op

    name = "fused" if fused else "unrolled"
    torch.cuda.reset_peak_memory_stats()
    rnn_op.reset_launches()
    stamps, infos = [], {}

    def stamp(p):
        b = p.locals["data_batch"]
        lbl = b.label[0].asnumpy()
        stamps.append((b.bucket_key, time.perf_counter(),
                       int((lbl != lstm_bucketing.INVALID_LABEL).sum())))
        # fit builds the steps again as it ends: read them inside it
        infos.update(p.locals["self"].step_info())

    t0 = time.perf_counter()
    model, data_train, _ = _ptb_main(mx, fused, seed, stamp)
    fit_s = time.perf_counter() - t0
    captured = _bucket_arrays(model)
    cudnn_fit = rnn_op.cudnn_calls
    # a bucket's first step warms up, its second captures: steady from its
    # third on
    seen, by_bucket = {}, {}
    tok = secs = 0.0
    for prev, cur in zip(stamps, stamps[1:]):
        key, dt = cur[0], cur[1] - prev[1]
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= 2:
            continue
        by_bucket.setdefault(key, []).append(dt * 1e3)
        tok += cur[2]
        secs += dt
    steady = {k: float(np.median(v)) for k, v in sorted(by_bucket.items())}
    out = {"fused": fused, "steps": len(stamps), "fit_s": fit_s,
           "steady_step_ms_by_bucket": steady,
           "steady_steps_by_bucket": {k: len(v)
                                      for k, v in sorted(by_bucket.items())},
           "tokens_per_s": tok / secs, "cudnn_calls_fit": cudnn_fit,
           "steps_by_bucket_in_fit": {k: infos[k] for k in sorted(infos)},
           **_memory()}
    check(len(stamps) == len(data_train.idx), f"{name}: one epoch of "
          f"{len(stamps)} batches")
    refusals = {k: i["refusal"] for k, i in infos.items()
                if i and i["refusal"]}
    # the probe steps: one a bucket, after fit rebuilt the steps
    data_train.reset()
    probes = {}
    for bucket in sorted(steady):
        place = next(i for i, (b, _) in enumerate(data_train.idx)
                     if data_train.buckets[b] == bucket)
        data_train.curr_idx = place
        batch = data_train.next()
        probes[bucket] = graph_step_probe(mx, model, batch, steady[bucket])
        probes[bucket].update(
            {k: model.step_info()[bucket][k] for k in
             ("captured", "refusal", "warmup_ms", "capture_ms")})
    out["probe_by_bucket"] = probes
    if fused:
        # the RNN op's counter counts Python calls (a bucket's warm-up and
        # capture, the evaluation); each probe step's trace shows what the
        # card ran
        ran = {k: p["rnn_kernels"] for k, p in probes.items()}
        check(all(n > 0 for n in ran.values()), f"{name}: each bucket's "
              f"traced step ran cuDNN's RNN kernels: {ran}")
    out["memory_after_probes"] = {
        "reserved_gb": torch.cuda.memory_reserved() / 1e9, **_memory()}
    print(f"  (a) {name}: captured "
          f"{sorted(k for k, i in infos.items() if i and i['captured'])}, "
          f"refused "
          f"{refusals}; steady ms by bucket {steady}; "
          f"{out['tokens_per_s']:.0f} tokens/s", flush=True)
    del model
    torch.cuda.empty_cache()
    eager = []
    for _ in range(2):
        with eager_steps():
            m, _, _ = _ptb_main(mx, fused, seed)
        eager.append(_bucket_arrays(m))
        del m
    out["vs_eager"] = hold_to_eager(
        f"(a) {name}", {"weights": captured}, *[{"weights": e} for e in eager],
        {"weights": PTB_LIMITS["weight"]})
    bad = [k for k, (a, b) in enumerate(zip(captured, split_weights))
           if not np.allclose(a.cpu().numpy(), b, rtol=GRAPH_SPLIT_RTOL,
                              atol=GRAPH_SPLIT_ATOL)]
    gap = max(float(np.abs(a.cpu().numpy() - b).max())
              for a, b in zip(captured, split_weights))
    check(len(captured) == len(split_weights) and not bad,
          f"(a) {name}: weights after the epoch within rtol "
          f"{GRAPH_SPLIT_RTOL}, atol {GRAPH_SPLIT_ATOL} of the split path's "
          f"(phase 12; largest gap {gap:.2e})")
    out["vs_split_max_abs"] = gap
    out["gate"] = ptb_gate(mx, fused)
    print("  " + json.dumps(out), flush=True)
    return out


def _fit_module(mx, seed):
    """ResNet-50 at phase 10's config (bf16 amp, batch 256, 224 px, SGD),
    its initial weights drawn from ``seed``."""
    symbol = resnet_symbol(mx, FIT_CLASSES, FIT_PX)
    args, aux = resnet_weights(symbol, FIT_BATCH, FIT_PX, seed)
    mod = mx.mod.Module(symbol, context=mx.gpu(0), amp="bfloat16")
    mod.bind(data_shapes=[("data", (FIT_BATCH, 3, FIT_PX, FIT_PX))],
             label_shapes=[("softmax_label", (FIT_BATCH,))])
    a, x_ = mx.convert.params_from_numpy(args, aux, mx.cpu())
    mod.init_params(arg_params=a, aux_params=x_)
    mod.init_optimizer(optimizer="sgd", optimizer_params=FIT_SGD)
    return mod


def _nll(probs, labels):
    import torch

    p = probs.float().gather(1, labels.long()[:, None])[:, 0]
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def graph_fit_compare(mx, seed):
    """(b) ResNet-50 steps from one start with deterministic cuDNN: the
    captured steps against two eager runs and the split path's losses;
    ``run_n_steps(4)`` against four single captured steps."""
    import torch

    gpu = mx.gpu(0)
    n = GRAPH_FIT_STEPS
    rng = np.random.default_rng(seed + 50)
    y = rng.integers(0, FIT_CLASSES, (2 * n, FIT_BATCH)).astype(np.float32)
    batches = []
    for i in range(2 * n):
        xb = rng.standard_normal((FIT_BATCH, 3, FIT_PX, FIT_PX),
                                 dtype=np.float32)
        batches.append(mx.io.DataBatch(data=[mx.nd.array(xb, mx.cpu())],
                                       label=[mx.nd.array(y[i], mx.cpu())]))
    labels = [torch.from_numpy(y[i]).to(gpu.torch_device)
              for i in range(2 * n)]

    def run(capture, split=False):
        if split:
            os.environ["MXTPU_NO_FUSED_STEP"] = "1"
        try:
            mod = _fit_module(mx, seed)
        finally:
            os.environ.pop("MXTPU_NO_FUSED_STEP", None)
        if not split:
            mod._fused_step_fn.capturable = capture
        losses = []
        for b, lab in zip(batches[:n], labels):
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            losses.append(_nll(mod.get_outputs()[0].data, lab))
        arrays = _module_arrays(mod) + [mod.get_outputs()[0].data.clone()]
        info = mod.step_info()
        del mod
        torch.cuda.empty_cache()
        return arrays, losses, info

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        got, losses, info = run(True)
        e1, _, _ = run(False)
        e2, _, _ = run(False)
        out = {"steps": n, "info": info, "losses": losses}
        check(info["captured"] and info["replays"] == n - 1,
              f"(b) the captured run replayed {info['replays']} of {n} steps")
        out["vs_eager"] = hold_to_eager(
            "(b) ResNet-50 bf16", {"state": got}, {"state": e1},
            {"state": e2}, {"state": GRAPH_WEIGHT_LIMIT})
        del got, e1, e2
        _, split_losses, _ = run(False, split=True)
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, split_losses))
        check(all(np.isfinite(losses)) and gap <= GRAPH_NLL_LIMIT,
              f"(b) captured losses {losses} within {GRAPH_NLL_LIMIT} of the "
              f"split path's {split_losses} (gap {gap:.2e})")
        out["split_losses"] = split_losses
        out["vs_split_nll_gap"] = gap
        # run_n_steps(4) against four single captured steps, both captured
        # first on two batches
        ends = []
        for multi in (False, True):
            mod = _fit_module(mx, seed)
            metric = mx.metric.create("acc")
            for b in batches[:2]:
                mod.forward(b, is_train=True)
                mod.backward()
                mod.update()
            if multi:
                mod.run_n_steps(batches[n:2 * n], eval_metric=metric)
            else:
                for b in batches[n:2 * n]:
                    mod.forward(b, is_train=True)
                    mod.backward()
                    mod.update()
                    mod.update_metric(metric, b.label)
            ends.append((_module_arrays(mod)
                         + [mod.get_outputs()[0].data.clone()],
                         metric.get()[1], mod.step_info()["replays"],
                         mod._optimizer.num_update))
            del mod
            torch.cuda.empty_cache()
        (a1, m1, r1, u1), (a4, m4, r4, u4) = ends
        same = all(torch.equal(a, b) for a, b in zip(a1, a4))
        check(same and m1 == m4 and r1 == r4 == n + 1 and u1 == u4 == n + 2,
              f"(b) run_n_steps({n}) bit-identical to {n} single captured "
              f"steps (arrays {same}, metric {m1} == {m4}, replays {r1} == "
              f"{r4}, updates {u1} == {u4})")
        out["run_n_steps_bit_identical"] = same
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def graph_rec_fit(mx, rec, pool, run_n, seed):
    """(b) one epoch of train_imagenet.py at phase 11's config with
    prefetch and ``MXNET_RUN_N_STEPS=run_n``: the steady step (a super-step
    over ``run_n``), img/s, the step's graph and a probe step."""
    import torch

    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    torch.cuda.reset_peak_memory_stats()
    it = rec_iter(mx, rec, pool)
    stamps, infos = [], []

    def stamp(p):
        stamps.append((p.nbatch, time.perf_counter()))
        # fit builds the step again as it ends: read it inside
        dp = p.locals["train_data"]
        infos[:] = [p.locals["self"].step_info(),
                    {"depth": dp._depth, "starved_count": dp.starved_count,
                     "staged_count": dp.staged_count}]
    os.environ["MXNET_DEVICE_PREFETCH"] = "1"
    os.environ["MXNET_RUN_N_STEPS"] = str(run_n)
    mx.random.seed(seed)
    t0 = time.perf_counter()
    try:
        mod = train_imagenet.main(
            ["--data-train", rec + ".rec", "--num-examples", str(REC_IMAGES),
             "--batch-size", str(REC_BATCH), "--num-epochs",
             str(GRAPH_REC_EPOCHS), "--disp-batches", "4"],
            data_loader=lambda a, kv: (it, None),
            batch_end_callback=[stamp])
    finally:
        os.environ.pop("MXNET_DEVICE_PREFETCH")
        os.environ.pop("MXNET_RUN_N_STEPS")
        it.close()
    secs = time.perf_counter() - t0
    steps = REC_IMAGES // REC_BATCH
    want = list(range(run_n - 1, steps, run_n))
    check([s[0] for s in stamps] == want * GRAPH_REC_EPOCHS,
          f"(b) n={run_n}: callbacks at batches {[s[0] for s in stamps]}")
    # per step: intervals between callbacks of one epoch over run_n; the
    # first super-step (warm-up and capture) comes before the first
    # callback, and for single steps the capture step is the first interval
    per = []
    for e in range(GRAPH_REC_EPOCHS):
        at = [s[1] for s in stamps[e * len(want):(e + 1) * len(want)]]
        gaps = list(np.diff(at) * 1e3 / run_n)
        per += gaps[1:] if e == 0 and run_n == 1 else gaps
    steady = float(np.median(per))
    info, stager = infos
    out = {"run_n_steps": run_n, "fit_s": secs, "step_ms": per,
           "stager": stager,
           "steady_step_ms": steady,
           "images_per_s": REC_BATCH / (steady / 1e3), "steps_in_fit": info,
           **_memory()}
    check(info["captured"] and info["replays"] == GRAPH_REC_EPOCHS * steps - 1,
          f"(b) n={run_n}: the step captured, {info['replays']} replays of "
          f"{GRAPH_REC_EPOCHS * steps} steps")
    probe_it = rec_iter(mx, rec, 0, augment=False,
                        parts=REC_IMAGES // REC_BATCH)
    batch = probe_it.next()
    probe_it.close()
    out["probe"] = graph_step_probe(mx, mod, batch, steady)
    out["probe"].update({k: mod.step_info()[k] for k in
                         ("captured", "warmup_ms", "capture_ms")})
    out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    _, aux = mod.get_params()
    check(all(np.isfinite(a.asnumpy()).all() for a in aux.values()),
          f"(b) n={run_n}: the moving statistics finite")
    print(f"  (b) n={run_n}: steady {steady:.1f} ms a step, "
          f"{out['images_per_s']:.0f} img/s; " + json.dumps(out), flush=True)
    del mod
    torch.cuda.empty_cache()
    return out


def _lm_named(mod):
    """The LM module's weights and Adam states by name (live tensors)."""
    ex = mod._exec_group._executor
    out = {}
    for name, i in zip(ex._diff_args, mod._fused_indices):
        out[name] = ex.arg_dict[name].data
        leaves = mod._optimizer._state_leaves(mod._updater.states.get(i))
        for k, t in enumerate(leaves):
            out[f"{name}:state{k}"] = t
    return out


def _worst(got, want):
    """The array whose gap is the largest share of its own max-abs (phase
    9's definition), with that share, its worst element and the values
    there and the array's max-abs."""
    worst = None
    for name, b in want.items():
        a = got[name].float()
        b = b.float()
        diff = (a - b).abs()
        scale = float(b.abs().max())
        rel = float(diff.max()) / max(scale, 1e-30)
        if worst is None or rel > worst["rel"]:
            k = int(diff.argmax())
            worst = {"name": name, "rel": rel, "element": k,
                     "got": float(a.reshape(-1)[k]),
                     "want": float(b.reshape(-1)[k]), "max_abs": scale}
    return worst


def _kernel_counts(fn):
    counts = {}
    by_name, _ = traced_groups(fn, {}, counts)
    return {k: counts[k] for k in by_name
            if "Memcpy" not in k and "Memset" not in k}


def graph_lm(mx, weights, seed, split_nll):
    """(c) phase 9's LM training step at full width, captured. The main
    path: six steps on phase 9's repeated batch, each under the profiler,
    which counts the bf16 flash kernels the card ran in it (the warm-up's,
    then each replay's: the wrapper's counter sees Python calls only, the
    warm-up's and the capture's); then steps timed alone and a probe step.
    Then the captured step held, step by step, to two eager runs started
    from the captured run's weights and Adam states: the per-token NLL and
    each gradient and state array bit-identical where the two eager runs
    are; where they part, the NLL within 1e-4 and the gradients within
    ``GRAPH_BF16_GRAD_LIMIT`` of their max-abs, beside a stale-gradient
    control; the captured update bit-identical to Adam's fused rule run
    eagerly on the captured step's own gradients and rates."""
    import torch

    from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reset_launches)

    gpu = mx.gpu(0)
    batch, y = lm_batch(mx, np.random.default_rng(seed + 11), TRAIN_BATCH,
                        SEQ, gpu)
    valid = torch.from_numpy(y.reshape(-1) != -1).to(gpu.torch_device)
    tokens = TRAIN_BATCH * SEQ

    def build(capture, grads=False):
        if grads:
            os.environ["MXTPU_FUSED_GRADS"] = "1"
        try:
            mod = lm_module(mx, LAYERS, TRAIN_BATCH, SEQ, weights, gpu,
                            "bfloat16", True)
        finally:
            os.environ.pop("MXTPU_FUSED_GRADS", None)
        mod._fused_step_fn.capturable = capture
        return mod

    def step(mod):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    def nll(mod):
        return mod.get_outputs()[0].data[valid].float()

    # the main path
    torch.cuda.reset_peak_memory_stats()
    mod = build(True)
    reset_launches()
    flash_tc, flash_f32, losses = [], [], []
    for _ in range(GRAPH_LM_STEPS):
        counts = _kernel_counts(lambda: step(mod))
        flash_tc.append(sum(c for k, c in counts.items()
                            if "flash_fwd_tc" in k))
        flash_f32.append(sum(c for k, c in counts.items()
                             if "flash_fwd" in k and "flash_fwd_tc" not in k))
        losses.append(float(nll(mod).mean()))
    calls = dict(flash_attention.launches_by_dtype)
    info = mod.step_info()
    step_ms = []
    for _ in range(GRAPH_LM_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(mod)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    steady = float(np.median(step_ms))
    out = {"losses": losses, "flash_tc_kernels_by_step": flash_tc,
           "flash_f32_kernels_by_step": flash_f32,
           "launches": sum(flash_tc), "wrapper_calls": calls, "info": info,
           "step_ms": step_ms, "steady_step_ms": steady,
           "tokens_per_s": tokens / (steady / 1e3)}
    out["probe"] = graph_step_probe(mx, mod, batch, steady)
    out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    out.update(_memory())
    del mod
    torch.cuda.empty_cache()
    check(info["captured"] and (info["warmups"], info["captures"],
                                info["replays"]) == (1, 1, GRAPH_LM_STEPS - 1),
          f"(c) the LM step warmed up, captured and replayed: {info}")
    check(flash_tc == [LAYERS] * GRAPH_LM_STEPS and sum(flash_f32) == 0,
          f"(c) the card ran {LAYERS} bf16 flash kernels in each step (the "
          f"warm-up, then each replay; traced): {flash_tc}, fp32 {flash_f32}")
    check(calls["bfloat16"] == 2 * LAYERS and calls["float32"] == 0,
          f"(c) the wrapper was called {2 * LAYERS} times (the warm-up and "
          f"the capture; a replay makes no call): {calls}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(c) NLL finite and falling on the repeated batch: {losses}")
    # the first step computes the split path's forward from the same
    # weights; later ones follow a trajectory whose own run-to-run spread
    # (the split path's nondeterministic kernels, magnified by Adam) passes
    # 1e-4 absolute by step 5: held relative to the loss
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, split_nll))
    check(losses[0] == split_nll[0] and gap <= GRAPH_NLL_LIMIT,
          f"(c) the first loss phase 9's ({losses[0]} == {split_nll[0]}), "
          f"the first {len(split_nll)} within {GRAPH_NLL_LIMIT} of its "
          f"(relative gap {gap:.2e})")
    out["vs_split_nll_gap"] = gap

    # step by step against the eager function, gradients kept
    # (MXTPU_FUSED_GRADS=1)
    cap = build(True, grads=True)
    eager = [build(False, grads=True) for _ in range(2)]
    steps, prev = [], None
    for t in range(GRAPH_LM_STEPS):
        if t:
            src = _lm_named(cap)
            for e in eager:
                for name, dst in _lm_named(e).items():
                    dst.copy_(src[name])
        cap._fused_states()   # Adam's zero states before the first step
        before = {k: v.clone() for k, v in _lm_named(cap).items()}
        runs = []
        for m in (cap, *eager):
            if t == 1 and m is eager[0]:
                # the first replay beside an eager step: their kernels
                kinds = {"replay": counts_cap, "eager": _kernel_counts(
                    lambda: step(m))}
            elif t == 1 and m is cap:
                counts_cap = _kernel_counts(lambda: step(m))
            else:
                step(m)
            g = m._exec_group.get_grads()
            runs.append({"nll": nll(m),
                         "grads": {k: g[k].data for k in sorted(g)},
                         "state": _lm_named(m)})
        c, e1, e2 = runs
        # the captured update against Adam's rule run eagerly on the
        # captured step's own gradients and rates
        prog = cap._fused_step_fn
        redo = {}
        with torch.no_grad():
            for p, (name, i) in enumerate(zip(prog.names, prog.indices)):
                w = before[name].clone()
                leaves = tuple(
                    before[f"{name}:state{k}"].clone() for k in range(len(
                        cap._optimizer._state_leaves(
                            cap._updater.states[i]))))
                cap._optimizer._tree_update(w, c["grads"][name], leaves,
                                            prog._lrs[p], prog._wds[p])
                redo[name] = w
                for k, x in enumerate(leaves):
                    redo[f"{name}:state{k}"] = x
        row = {"step": t + 1,
               "update_bit_identical": all(torch.equal(redo[k], c["state"][k])
                                           for k in redo),
               "nll_eager_bit_identical": torch.equal(e1["nll"], e2["nll"]),
               "nll_bit_identical": torch.equal(c["nll"], e1["nll"]),
               "nll_abs": float((c["nll"] - e1["nll"]).abs().max()),
               "nll_abs_eager_spread": float((e2["nll"] - e1["nll"]).abs()
                                             .max())}
        for part in ("grads", "state"):
            differ = [k for k in e1[part]
                      if not torch.equal(e1[part][k], e2[part][k])]
            row[part] = {
                "eager_runs_differ_in": differ,
                "bit_identical_where_eager_is": all(
                    torch.equal(c[part][k], e1[part][k])
                    for k in e1[part] if k not in differ),
                "gap": _worst({k: c[part][k] for k in differ},
                              {k: e1[part][k] for k in differ})
                if differ else None,
                "eager_spread": _worst({k: e2[part][k] for k in differ},
                                       {k: e1[part][k] for k in differ})
                if differ else None}
        differ = row["grads"]["eager_runs_differ_in"]
        # a control the limit must tell apart: the same leaves' gradients
        # one step stale
        row["grads"]["stale_control"] = _worst(
            prev, {k: e1["grads"][k] for k in prev}) \
            if prev and set(prev) == set(differ) else None
        prev = {k: e1["grads"][k].clone() for k in differ}
        steps.append(row)
        del runs, c, e1, e2, before, redo
        print(f"  (c) step {t + 1}: " + json.dumps(row), flush=True)
    del cap, eager, prev
    torch.cuda.empty_cache()
    out["vs_eager_by_step"] = steps
    only = {k[:100]: [kinds["replay"].get(k, 0), kinds["eager"].get(k, 0)]
            for k in set(kinds["replay"]) | set(kinds["eager"])
            if kinds["replay"].get(k, 0) != kinds["eager"].get(k, 0)}
    out["kernels_replay_vs_eager_differ"] = only
    print(f"  (c) kernels whose count differs, [replay, eager]: "
          f"{json.dumps(only)}", flush=True)
    for row in steps:
        n = row["step"]
        check(row["update_bit_identical"], f"(c) step {n}: the captured "
              "update bit-identical to Adam's rule on its own gradients and "
              "rates")
        check(row["nll_bit_identical"] if row["nll_eager_bit_identical"]
              else row["nll_abs"] <= GRAPH_NLL_LIMIT,
              f"(c) step {n}: the per-token NLL bit-identical to the eager "
              f"function's where two eager runs are, else within "
              f"{GRAPH_NLL_LIMIT} (gap {row['nll_abs']:.3g})")
        for part in ("grads", "state"):
            check(row[part]["bit_identical_where_eager_is"],
                  f"(c) step {n}: every {part} array bit-identical to the "
                  "eager function's where two eager runs are")
        gap = row["grads"]["gap"]
        check(gap is None or gap["rel"] <= GRAPH_BF16_GRAD_LIMIT,
              f"(c) step {n}: the gradients the eager runs part on "
              f"({row['grads']['eager_runs_differ_in']}) within "
              f"{GRAPH_BF16_GRAD_LIMIT:.3g} of max-abs (worst {gap})")
    summary = {k: v for k, v in out.items() if k != "vs_eager_by_step"}
    print("  (c) " + json.dumps(summary), flush=True)
    return out


def phase_step_graph(mx, weights, seed, rec, ptb_split, train_nll):
    """The one-program training step: (a) LSTM-PTB through
    lstm_bucketing.py, unrolled and fused; (b) ResNet-50 from the .rec with
    ``MXNET_RUN_N_STEPS`` 1 and 4; (c) the LM training step."""
    import torch

    print("phase 13: the one-program step (the fused step captured as one "
          "CUDA graph a binding)", flush=True)
    out = {"ptb": {}}
    for fused in (False, True):
        out["ptb"]["fused" if fused else "unrolled"] = graph_ptb(
            mx, fused, seed, ptb_split[fused])
        torch.cuda.empty_cache()
    out["fit_compare"] = graph_fit_compare(mx, seed)
    pool = decode_pool_size()
    out["fit"] = [graph_rec_fit(mx, rec, pool, n, seed) for n in (1, 4)]
    out["lm"] = graph_lm(mx, weights, seed, train_nll)
    return out


# phase 14: the image-classification family
ZOO_BATCH, ZOO_BATCHES, ZOO_CLASSES = FIT_BATCH, FIT_BATCHES, FIT_CLASSES
ZOO_TRAIN = (("alexnet", {}, 224), ("inception-v3", {}, 299))
ZOO_INFER = (("resnet", {"num_layers": 50}, 224), ("alexnet", {}, 224),
             ("inception-bn", {}, 224), ("inception-v3", {}, 299))
ZOO_INFER_CONFIGS = ((1, "float32"), (32, "float32"), (32, "bfloat16"))
ZOO_SCORE_BATCHES = 50      # benchmark_score.py's num_batches (its default)
ZOO_SCORE_ORDER = ("captured", "eager", "eager", "captured", "captured",
                   "eager")
ZOO_IDLE_FORWARDS = 10      # captured forwards in the traced idle window
ZOO_SPLIT_STEPS = 2
# the nine builders' card-vs-CPU step: phase 10's batch (8), each at a
# small image it takes
ZOO_SMALL = (("mlp", {}, (8, 1, 28, 28)), ("lenet", {}, (8, 1, 28, 28)),
             ("alexnet", {}, (8, 3, 224, 224)),
             ("vgg", {"num_layers": 11}, (8, 3, 32, 32)),
             ("googlenet", {}, (8, 3, 64, 64)),
             ("inception-bn", {}, (8, 3, 64, 64)),
             ("inception-v3", {}, (8, 3, 299, 299)),
             ("inception-resnet-v2", {}, (8, 3, 299, 299)),
             ("resnext", {"num_layers": 50, "image_shape": "3,64,64"},
              (8, 3, 64, 64)))
ZOO_SMALL_CLASSES = 16
# AlexNet's two LRNs at batch 256 (after its first two poolings)
LRN_SHAPES = ((256, 96, 26, 26), (256, 256, 12, 12))
LRN_ATTRS = {"alpha": 1e-4, "beta": 0.75, "knorm": 1.0, "nsize": 5}
LRN_BF16_LIMIT = 2e-2       # of the fp32 output's max-abs (at least 1)
ZOO_OPS = {"conv_fwd": ("Convolution",), "bn_fwd": ("BatchNorm",),
           "pool": ("Pooling",), "lrn": ("LRN",),
           "fc_softmax": ("FullyConnected", "SoftmaxOutput", "Flatten"),
           "dropout": ("Dropout",), "relu_concat": ("Activation", "Concat")}
ZOO_RANGES = {
    "conv_fwd": ("chip_smoke::conv_fwd",),
    "conv_bwd": (_NODE + "ConvolutionBackward0",),
    "bn_fwd": ("chip_smoke::bn_fwd",),
    "bn_bwd": (_NODE + "_BatchNormTrainBackward",),
    "pool": ("chip_smoke::pool", _NODE + "MaxPool2DWithIndicesBackward0",
             _NODE + "AvgPool2DBackward0", _NODE + "MeanBackward1"),
    # LRN's backward is autograd's over its composition (the zoo has no
    # other op that records these nodes)
    "lrn": ("chip_smoke::lrn",) + tuple(_NODE + n for n in (
        "PowBackward0", "PowBackward1", "ConstantPadNdBackward0",
        "SliceBackward0", "MulBackward0", "AddBackward0")),
    "fc_softmax": ("chip_smoke::fc_softmax", _NODE + "AddmmBackward0",
                   _NODE + "_SoftmaxOutputBackward"),
    "dropout": ("chip_smoke::dropout", _NODE + "WhereBackward0",
                _NODE + "DivBackward0"),
    "relu_concat": ("chip_smoke::relu_concat", _NODE + "ReluBackward0",
                    _NODE + "CatBackward0"),
    "amp_cast": ("chip_smoke::amp_cast", _NODE + "ToCopyBackward0"),
    "sgd_update": ("chip_smoke::sgd_update",),
}
ZOO_NEEDED = {"alexnet": ("conv_fwd", "conv_bwd", "lrn", "dropout"),
              "inception-v3": ("conv_fwd", "conv_bwd", "bn_fwd", "bn_bwd")}


def zoo_scripts(mx, tmp):
    """(a) and (e): the port's train_mnist.py --network lenet at its
    defaults on the synthetic digits (no idx files), then score.py and
    fine_tune.py, on the card, each against its gate."""
    from mxnet_tpu_torch.examples.image_classification import (
        fine_tune, score, train_mnist)

    out = {}
    t0 = time.perf_counter()
    mod, acc = train_mnist.main(["--network", "lenet", "--data-dir",
                                 os.path.join(tmp, "no_mnist")])
    out["train_mnist_lenet"] = {
        "validation_accuracy": acc, "seconds": time.perf_counter() - t0,
        "eval_forward": mod._exec_group._executor.forward_info()}
    print("  (a) train_mnist.py --network lenet: "
          + json.dumps(out["train_mnist_lenet"]), flush=True)
    check(acc >= 0.95, f"train_mnist.py lenet validation accuracy {acc:.4f} "
          ">= 0.95")
    del mod
    t0 = time.perf_counter()
    metrics = dict(m.get() for m in score.main(
        ["--prefix", os.path.join(tmp, "score_demo")]))
    out["score"] = dict(metrics, seconds=time.perf_counter() - t0)
    check(metrics["accuracy"] >= 0.95
          and np.isfinite(metrics["cross-entropy"]),
          f"score.py accuracy {metrics['accuracy']:.4f} >= 0.95, "
          f"cross-entropy {metrics['cross-entropy']:.4f} finite")
    t0 = time.perf_counter()
    acc, drift = fine_tune.main(["--prefix", os.path.join(tmp, "ft_base")])
    out["fine_tune"] = {"accuracy": acc, "frozen_drift": drift,
                        "seconds": time.perf_counter() - t0}
    print("  (e) score.py, fine_tune.py: " + json.dumps(
        {k: out[k] for k in ("score", "fine_tune")}), flush=True)
    check(drift == 0.0 and acc >= 0.9, f"fine_tune.py: frozen drift {drift} "
          f"== 0, head accuracy {acc:.3f} >= 0.9")
    return out


def zoo_train(mx, name, kw, px, seed):
    """(b) ``name`` through ``Module.fit`` at phase 10's config (bench.py's
    accelerator config) with the fused step captured: steady step and
    img/s, the captured step's idle share, memory, captures; then the split
    path: one step traced into ``ZOO_RANGES``' groups and steps timed."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    rng = np.random.default_rng(seed + 140)
    n = ZOO_BATCH * ZOO_BATCHES
    x = rng.standard_normal((n, 3, px, px), dtype=np.float32)
    y = rng.integers(0, ZOO_CLASSES, n).astype(np.float32)
    train = mx.io.NDArrayIter(x, y, batch_size=ZOO_BATCH)
    symbol = mx.models.get_model(name).get_symbol(
        num_classes=ZOO_CLASSES, image_shape=f"3,{px},{px}", **kw)
    mod = mx.mod.Module(symbol, context=gpu, amp="bfloat16")
    ready, stamps = [], []
    init_optimizer = mod.init_optimizer

    def init_optimizer_marked(*a, **k):
        init_optimizer(*a, **k)
        torch.cuda.synchronize()
        ready.append(time.perf_counter())

    mod.init_optimizer = init_optimizer_marked
    metric = mx.metric.create("acc")
    mx.random.seed(seed + 140)
    infos = []

    def batch_end(param):
        stamps.append(time.perf_counter())
        # (fit's step is built anew when fit ends: read it from inside)
        infos.append(mod.step_info())

    t0 = time.perf_counter()
    mod.fit(train, eval_metric=metric, num_epoch=1, optimizer="sgd",
            optimizer_params=FIT_SGD,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=batch_end)
    step_ms = list(np.diff(ready + stamps) * 1e3)
    check(len(step_ms) == ZOO_BATCHES, f"{name}: fit ran {len(step_ms)} == "
          f"{ZOO_BATCHES} batches")
    steady = float(np.median(step_ms[2:]))
    info = infos[-1]
    out = {"batch": ZOO_BATCH, "px": px, "classes": ZOO_CLASSES,
           "fit_s": time.perf_counter() - t0, "setup_s": ready[0] - t0,
           "step_ms": step_ms, "steady_step_ms": steady,
           "images_per_s": ZOO_BATCH / (steady / 1e3),
           "train_accuracy": metric.get()[1], "step": info, **_memory()}
    print(f"  (b) {name}: steady {steady:.2f} ms, "
          f"{out['images_per_s']:.0f} img/s, {info}", flush=True)
    check(info["captured"] and info["captures"] == 1
          and info["replays"] == ZOO_BATCHES - 1,
          f"{name}: one capture and {ZOO_BATCHES - 1} replays ({info})")
    # the probe steps take a batch already on the card (its feed a copy on
    # the device): the step as the card runs it, without fit's host feed
    train.reset()
    host_batch = train.next()
    dev_batch = mx.io.DataBatch(
        data=[a.as_in_context(gpu) for a in host_batch.data],
        label=[a.as_in_context(gpu) for a in host_batch.label])
    probe = out["probe"] = graph_step_probe(mx, mod, dev_batch, steady)
    out["device_batch_step_ms"] = probe["event_ms"]
    out["device_batch_images_per_s"] = ZOO_BATCH / (probe["event_ms"] / 1e3)
    out["device_batch_idle_share"] = 1.0 - probe["kernel_busy_ms"] \
        / probe["event_ms"]
    out["reserved_after_probe_gb"] = torch.cuda.memory_reserved() / 1e9
    # the split path on the same binding: its traced step splits the device
    # time by op group (a replay has no host ranges to group by; it runs
    # the same kernels)
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"
    try:
        mod._refresh_fused_step()
        train.reset()
        _, out["split_traced_step"] = trace_fit_step(
            mx, mod, train, metric, ops=ZOO_OPS, ranges=ZOO_RANGES,
            needed=ZOO_NEEDED[name])
        split = [timed(lambda: (mod.forward(dev_batch, is_train=True),
                                mod.backward(), mod.update()))[1]
                 for _ in range(ZOO_SPLIT_STEPS)]
    finally:
        os.environ.pop("MXTPU_NO_FUSED_STEP")
    out["split_step_ms"] = split
    out["split_over_captured"] = float(np.median(split)) \
        / out["device_batch_step_ms"]
    traced = out["split_traced_step"]
    print(f"  (b) {name} on a batch on the card: captured "
          f"{out['device_batch_step_ms']:.2f} ms "
          f"({out['device_batch_images_per_s']:.0f} img/s, idle "
          f"{out['device_batch_idle_share']:.3f}), split "
          f"{[round(t, 2) for t in split]} ms; the split step's traced "
          f"device ms by group {json.dumps(traced['split_ms'])}; captured "
          f"probe {json.dumps(probe)}", flush=True)
    del mod, train, x, y
    torch.cuda.empty_cache()
    return out


def zoo_infer(mx):
    """(c) benchmark_score.py's path and bench.py's inference mode: each
    network and config bound forward-only, its captured forward's img/s by
    the script's method beside the eager walk's in turns, the outputs of
    the two compared, the output copy and the idle share."""
    import torch

    from mxnet_tpu_torch.examples.image_classification import (
        benchmark_score as bs)

    rows = []
    for name, kw, px in ZOO_INFER:
        for b, dtype in ZOO_INFER_CONFIGS:
            mod, batch = bs.bind_scorer(name, b, (3, px, px), dtype,
                                        mx.gpu(0), **kw)
            eg = mod._exec_group
            ex = eg._executor
            eager_out = []

            def captured():
                mod.forward(batch, is_train=False)

            def eager():
                eg._load_into(eg.data_names, batch.data)
                eager_out[:] = ex.eager_forward()

            def read_captured():
                return float(mod.get_outputs()[0].asnumpy().ravel()[0])

            def read_eager():
                return float(eager_out[0].reshape(-1)[0])

            rates = {"captured": [], "eager": []}
            for mode in ZOO_SCORE_ORDER:
                fn, read = (captured, read_captured) if mode == "captured" \
                    else (eager, read_eager)
                rates[mode].append(bs.images_per_s(fn, read, b,
                                                   ZOO_SCORE_BATCHES))
            captured()
            got = mod.get_outputs()[0].data
            want = ex.eager_forward()[0]
            bit = torch.equal(got, want)
            err = float((got.float() - want.float()).abs().max())
            info = ex.forward_info()
            static = ex._eval_program._static
            copy_ms = time_cuda(lambda: [o.clone() for o in static])
            fwd_ms = 1e3 * b / float(np.median(rates["captured"]))
            # the idle share of a window of captured forwards, its device
            # time and its host time from the same traced run
            window = []
            busy = device_busy_ms(lambda: window.append(timed(
                lambda: [captured() for _ in range(ZOO_IDLE_FORWARDS)])[1]))
            cap, eag = rates["captured"], rates["eager"]
            row = {"network": name, "batch": b, "dtype": dtype, "px": px,
                   "num_batches": ZOO_SCORE_BATCHES,
                   "captured_img_s": cap, "eager_img_s": eag,
                   "captured_over_eager": float(np.median(cap))
                   / float(np.median(eag)),
                   "captured_over_eager_range": [min(cap) / max(eag),
                                                 max(cap) / min(eag)],
                   "forward_ms": fwd_ms,
                   "device_busy_ms": busy / ZOO_IDLE_FORWARDS
                   if busy else None,
                   "idle_share": 1.0 - busy / window[0] if busy else None,
                   "output_copy_ms": copy_ms, "bit_identical": bit,
                   "max_abs_err": err, "forward": info}
            rows.append(row)
            print(f"  (c) {name} batch {b} {dtype}: captured "
                  f"{[round(r, 1) for r in rates['captured']]} img/s, eager "
                  f"{[round(r, 1) for r in rates['eager']]}; idle "
                  f"{row['idle_share']}; copy {copy_ms:.4f} ms; bit "
                  f"{bit} ({err:.3g}); {info}", flush=True)
            check(info["captured"] and info["captures"] == 1
                  and info["drops"] == 0,
                  f"{name} batch {b} {dtype}: one capture for the binding "
                  f"({info})")
            # the same kernels run eagerly and replayed: bit-identical,
            # else phase 10's probability limit
            check(bit or err <= 1e-4, f"{name} batch {b} {dtype}: captured "
                  f"output bit-identical to the eager walk's, or within "
                  f"1e-4 ({err:.3g})")
            del mod, batch, eg, ex, static, got, want, eager_out
            torch.cuda.empty_cache()
    return rows


def zoo_card_vs_cpu(mx, seed):
    """(d) one fp32 SGD step of each of the nine builders at a small input
    on the card against the CPU (phase 10's limits, through
    :func:`step_card_vs_cpu`), and LRN in bf16 on the card against an fp32
    plain version at AlexNet's shapes. The steps run as the main path
    does, on cuDNN (whose fp32 convolution weight gradients the port's op
    takes off cuDNN with TF32 off, phase 1)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    out = {}
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"
    try:
        for i, (name, kw, shape) in enumerate(ZOO_SMALL):
            symbol = mx.models.get_model(name).get_symbol(
                num_classes=ZOO_SMALL_CLASSES, **kw)
            weights = net_weights(symbol, shape, seed + 150 + i)
            rng = np.random.default_rng(seed + 170 + i)
            x = rng.standard_normal(shape, dtype=np.float32)
            y = rng.integers(0, ZOO_SMALL_CLASSES, shape[0]).astype(
                np.float32)
            out[name] = step_card_vs_cpu(mx, symbol, weights, x, y,
                                         f"{name} fp32 step at {shape}")
    finally:
        os.environ.pop("MXTPU_NO_FUSED_STEP")
    lrn = get_op("LRN")
    ctx = OpCtx(is_train=False, device=torch.device("cuda", 0))
    gen = torch.Generator().manual_seed(seed + 180)
    out["lrn_bf16"] = []
    for shape in LRN_SHAPES:
        x = torch.randn(shape, generator=gen).cuda()
        got = lrn.fn(ctx, LRN_ATTRS, x.bfloat16())
        want = F.local_response_norm(
            x, LRN_ATTRS["nsize"], alpha=LRN_ATTRS["alpha"],
            beta=LRN_ATTRS["beta"], k=LRN_ATTRS["knorm"])
        err = float((got.float() - want).abs().max()) \
            / max(1.0, float(want.abs().max()))
        out["lrn_bf16"].append({"shape": list(shape), "dtype": str(got.dtype),
                                "max_rel_err": err})
        check(got.dtype == torch.bfloat16 and err <= LRN_BF16_LIMIT,
              f"LRN in bf16 at {shape} against fp32: {err:.3g} <= "
              f"{LRN_BF16_LIMIT} of max-abs")
    print("  (d) LRN bf16 vs fp32: " + json.dumps(out["lrn_bf16"]),
          flush=True)
    return out


def phase_zoo(mx, seed, tmp):
    """The image-classification family: (a) train_mnist.py's LeNet, (b)
    AlexNet and Inception-v3 training, (c) inference, (d) card vs CPU, (e)
    score.py and fine_tune.py."""
    print("phase 14: the image-classification family", flush=True)
    t0 = time.perf_counter()
    out = zoo_scripts(mx, tmp)
    out["train"] = {name: zoo_train(mx, name, kw, px, seed)
                    for name, kw, px in ZOO_TRAIN}
    out["infer"] = zoo_infer(mx)
    out["card_vs_cpu"] = zoo_card_vs_cpu(mx, seed)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 15: object detection (SSD and Faster R-CNN) ----------------------

DET_SSD_EPOCHS = 8          # (a): evaluate.py's gate run (tests/test_ssd_example.py)
DET_SSD_MAP = {0.5: 0.5, 0.75: 0.2}
DET_SPLIT_STEPS = 5         # (a): split steps timed on a batch on the card
DET_CPU_BATCH = 8           # (b)
DET_LR = 5e-3               # train.py's Adam rate
DET_RCNN = dict(epochs=10, batch=4, steps_per_epoch=24, seed=0)
DET_RCNN_GATE = {"accuracy": 0.8, "mean_iou": 0.5}
# (d): SSD-300's six maps (example/ssd/symbol/symbol_vgg16_ssd_300.py:
# sizes and ratios per map), 8732 anchors; VOC's 20 classes and background
SSD300_MAPS = ((38, (0.1, 0.141), (1.0, 2.0, 0.5)),
               (19, (0.2, 0.272), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (10, (0.37, 0.447), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (5, (0.54, 0.619), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)),
               (3, (0.71, 0.79), (1.0, 2.0, 0.5)),
               (1, (0.88, 0.961), (1.0, 2.0, 0.5)))
SSD300_BATCH, SSD300_CLASSES, SSD300_GT = 32, 21, 16
# Proposal at its own defaults on VGG-16's conv5 map of a 600 x 1000 image
VGG_RPN_MAP = (38, 63)
DET_OP_REPS = 4             # (d): calls a time_device round
DET_OPS = {"conv_fwd": ("Convolution",), "pool": ("Pooling",),
           "relu": ("Activation",), "prior": ("MultiBoxPrior",),
           "target": ("MultiBoxTarget",),
           "softmax_loss": ("SoftmaxOutput", "smooth_l1", "MakeLoss"),
           "reshape": ("transpose", "Reshape", "Flatten", "Concat")}
DET_RANGES = {
    "conv_fwd": ("chip_smoke::conv_fwd",),
    # with TF32 off the fp32 weight gradient leaves cuDNN (phase 1)
    "conv_bwd": (_NODE + "ConvolutionBackward0",
                 _NODE + "_ConvIeeeWeightGradBackward"),
    "pool": ("chip_smoke::pool", _NODE + "MaxPool2DWithIndicesBackward0"),
    "relu": ("chip_smoke::relu", _NODE + "ReluBackward0"),
    "prior": ("chip_smoke::prior",),
    "target": ("chip_smoke::target",),
    "softmax_loss": ("chip_smoke::softmax_loss",
                     _NODE + "_SoftmaxOutputBackward",
                     _NODE + "_MakeLossBackward"),
    "reshape": ("chip_smoke::reshape", _NODE + "PermuteBackward0",
                _NODE + "ViewBackward0", _NODE + "CatBackward0"),
    "adam_update": ("chip_smoke::adam_update",),
}


class StepClock:
    """While installed, ``Module.update`` keeps, after each update, the
    time, its module (the first one) and the module's ``step_info()``, and
    calls ``then()``: the examples' loops update once a step, so the
    stamps' differences are the steps' times."""

    def __init__(self, mx, then=None):
        self.cls, self.then = mx.mod.Module, then
        self.update = self.cls.update
        self.stamps, self.infos, self.modules = [], [], []

    def __enter__(self):
        update = self.update

        def clocked(mod):
            update(mod)
            self.stamps.append(time.perf_counter())
            self.infos.append(mod.step_info())
            if not self.modules:
                self.modules.append(mod)
            if self.then is not None:
                self.then()

        self.cls.update = clocked
        return self

    def __exit__(self, *exc):
        self.cls.update = self.update


def det_weights(symbol, shapes, seed):
    """Fan-in scaled numpy weights for every argument of ``symbol`` but
    the inputs named in ``shapes``."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    return {n: (rng.standard_normal(s, dtype=np.float32)
                / np.sqrt(np.prod(s[1:]) if len(s) > 1 else 1))
            .astype(np.float32)
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def det_split_trace(mx, mod, batch):
    """One split step of ``mod`` on ``batch`` traced into ``DET_RANGES``'
    groups, with the host's ms by part (forward, backward, update: the
    time to issue each) and the step's ms with the card done."""
    import torch

    host = {}

    def clock(key, fn):
        t = time.perf_counter()
        fn()
        host[key] = (time.perf_counter() - t) * 1e3

    def step():
        clock("forward", lambda: mod.forward(batch, is_train=True))
        clock("backward", mod.backward)
        with torch.profiler.record_function("chip_smoke::adam_update"):
            clock("update", mod.update)

    saved = []
    for group, names in DET_OPS.items():
        saved += _wrap_ops(names, "chip_smoke::" + group)
    traced = []
    try:
        by_name, groups = traced_groups(lambda: traced.append(timed(step)),
                                        DET_RANGES)
    finally:
        for op, fn in saved:
            op.fn = fn
    check(by_name, "the profiler recorded device events for the SSD step")
    split = {g: sum(t for k, t in ks if "Memcpy" not in k)
             for g, ks in groups.items()}
    busy = sum(t for k, t in by_name.items() if "Memcpy" not in k)
    split["rest"] = busy - sum(split.values())
    check(split["target"] > 0 and split["conv_fwd"] > 0,
          "the traced SSD step ran MultiBoxTarget's and the convolutions' "
          "kernels")
    (_, wall), = traced
    return {"host_split_ms": host, "step_ms": wall, "kernel_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "device_ms_by_group": split,
            "device_kernels": len(by_name),
            "top_kernels": [[k[:80], t] for k, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]]}


def det_ssd(mx, seed):
    """(a) ``examples/ssd/evaluate.py``'s ``train_and_map`` on the card (the
    fused step captured) and its mAP gate; the steady step; on a batch on
    the card, the captured step (probe: kernels, idle share) against the
    split step (traced by group, host ms by part); ``train.py`` at its
    defaults. Returns the numbers and the trained weights."""
    import torch

    from mxnet_tpu_torch.examples.ssd import evaluate, train

    gpu = mx.gpu(0)
    t0 = time.perf_counter()
    with StepClock(mx) as clock:
        maps = evaluate.train_and_map(epochs=DET_SSD_EPOCHS, ctx=gpu,
                                      seed=seed,
                                      log=lambda m: print("  (a) " + m,
                                                          flush=True))
    total_s = time.perf_counter() - t0
    mod = clock.modules[0]
    step_ms = list(np.diff(clock.stamps) * 1e3)
    steady = float(np.median(step_ms[2:]))
    info = clock.infos[-1]
    out = {"maps": {str(k): v for k, v in maps.items()}, "seconds": total_s,
           "steps": len(clock.stamps), "steady_step_ms": steady,
           "images_per_s": 32 / (steady / 1e3), "step": info}
    print(f"  (a) SSD: mAP {maps}, {len(clock.stamps)} steps, steady "
          f"{steady:.2f} ms (the loop's host loss and 4 output copies "
          f"included), step {info}", flush=True)
    for t, least in DET_SSD_MAP.items():
        check(maps[t] >= least, f"SSD mAP@{t} {maps[t]:.3f} >= {least}")
    check(info["captured"] and info["captures"] == 1,
          f"SSD's fused step captured once ({info})")
    # on a batch on the card: the captured step, then the split path on the
    # same binding
    x, y = train.make_dataset(32, np.random.RandomState(seed + 150))
    batch = mx.io.DataBatch(data=[mx.nd.array(x, gpu)],
                            label=[mx.nd.array(y, gpu)])
    probe = out["captured_probe"] = graph_step_probe(mx, mod, batch, steady)
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"
    try:
        mod._refresh_fused_step()
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        out["split_traced"] = det_split_trace(mx, mod, batch)
        split = [timed(lambda: (mod.forward(batch, is_train=True),
                                mod.backward(), mod.update()))[1]
                 for _ in range(DET_SPLIT_STEPS)]
    finally:
        os.environ.pop("MXTPU_NO_FUSED_STEP")
        mod._refresh_fused_step()
    out["split_step_ms"] = split
    out["captured_step_ms"] = probe["event_ms"]
    out["split_over_captured"] = float(np.median(split)) / probe["event_ms"]
    print(f"  (a) SSD on a batch on the card: captured "
          f"{probe['event_ms']:.3f} ms ({probe['kernels']} kernels, idle "
          f"{1 - probe['kernel_busy_ms'] / probe['event_ms']:.3f}), split "
          f"{[round(t, 3) for t in split]} ms; split traced "
          f"{json.dumps(out['split_traced'])}", flush=True)
    weights = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    t0 = time.perf_counter()
    miou, acc = train.main([])
    out["train_py"] = {"mean_iou": miou, "class_accuracy": acc,
                       "seconds": time.perf_counter() - t0}
    print(f"  (a) train.py at its defaults: {out['train_py']}", flush=True)
    check(np.isfinite(miou) and 0.0 <= acc <= 1.0,
          "train.py reports a finite mean IoU and a class accuracy")
    del mod, clock
    torch.cuda.empty_cache()
    return out, weights


def _mining_gap(probs, anchors, label, ratio=3.0, thresh=0.5):
    """The hardness gap at each sample's keep boundary of MultiBoxTarget's
    negative mining (numpy, from the class probabilities)."""
    from mxnet_tpu_torch.ops.contrib_det import _iou_matrix

    import torch

    a = torch.from_numpy(np.ascontiguousarray(anchors)).reshape(-1, 4)
    gaps = []
    for b in range(label.shape[0]):
        valid = label[b, :, 0] >= 0
        iou = _iou_matrix(a, torch.from_numpy(label[b, :, 1:5])).numpy()
        iou = np.where(valid[None], iou, -1.0)
        pos = iou.max(1) >= thresh
        pos[iou.argmax(0)[valid]] = True
        hard = np.sort(probs[b, 1:].max(0)[~pos])[::-1]
        keep = int(ratio * pos.sum())
        gaps.append(float(hard[keep - 1] - hard[keep])
                    if 0 < keep < len(hard) else None)
    return gaps


def _softmax_np(x, axis=1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _targets_part_at_ties(got, want, gaps, limit):
    """MultiBoxTarget's ``got`` against ``want`` (numpy outputs, batch
    first): the samples whose class targets or masks differ, and whether
    each of them has its mining boundary within ``limit`` (``gaps`` from
    :func:`_mining_gap`) and the rest of the targets match exactly."""
    rows = (got[2] != want[2]).any(1) | (got[1] != want[1]).any(1)
    same = ~rows
    ok = bool((got[0][same] == want[0][same]).all() or _rel(
        got[0][same], want[0][same]) <= 1e-5)
    at_ties = all(gaps[i] is not None and gaps[i] <= limit
                  for i in np.flatnonzero(rows))
    return [int(i) for i in np.flatnonzero(rows)], ok and at_ties


def _ssd_outputs_held(gpu, cpu):
    """SSD's training outputs card vs CPU: cls_prob and loc_loss within
    1e-4 (of max(1, max-abs) for the loss)."""
    cls = float(np.abs(gpu[0] - cpu[0]).max())
    loc = float(np.abs(gpu[1] - cpu[1]).max())
    ok = np.isfinite(gpu[0]).all() and cls <= 1e-4 \
        and loc <= 1e-4 * max(1.0, float(np.abs(cpu[1]).max()))
    return ({"cls_prob_max_abs_err": cls, "loc_loss_max_abs_err": loc},
            bool(ok), f"cls_prob {cls:.3g} and loc_loss {loc:.3g} within "
            "1e-4")


def det_card_vs_cpu(mx, seed, trained):
    """(b) one fp32 Adam step of SSD's training graph at batch 8 with the
    same weights on the card (cuDNN, TF32 off, the split path) and on the
    CPU, through :func:`step_card_vs_cpu`: the CPU and a float64 CPU step
    on the card's ReLU masks, max-pool choices and MultiBoxTarget outputs.
    MultiBoxTarget on the CPU on the card's inputs must give the card's
    targets exactly; where the CPU's own inputs give other targets, each
    sample that differs must sit at a mining near-tie. Then the detection
    graph at the weights trained in (a), card against CPU."""
    import torch

    from mxnet_tpu_torch.examples.ssd import symbol as ssd_symbol
    from mxnet_tpu_torch.examples.ssd import train
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    x, y = train.make_dataset(DET_CPU_BATCH, np.random.RandomState(seed + 160))
    sym = ssd_symbol.get_ssd_train(2)
    weights = det_weights(sym, {"data": x.shape, "label": y.shape},
                          seed + 161)
    targets = {"MultiBoxTarget": {}}
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"
    try:
        res = step_card_vs_cpu(
            mx, sym, (weights, {}), x, y,
            f"SSD fp32 Adam step at batch {DET_CPU_BATCH}",
            optimizer=("adam", {"learning_rate": DET_LR}), label="label",
            replay=targets, held=_ssd_outputs_held)
    finally:
        os.environ.pop("MXTPU_NO_FUSED_STEP")
    rec = targets["MultiBoxTarget"]
    (t_ins, t_outs), = rec["card"]
    card = [t.numpy() for t in t_outs]
    # MultiBoxTarget on the CPU on the card's inputs: the card's targets
    cpu_t = get_op("MultiBoxTarget").fn(
        OpCtx(device=torch.device("cpu")),
        {"overlap_threshold": 0.5, "negative_mining_ratio": 3}, *t_ins)
    res["target_on_card_inputs"] = {
        "cls_target_equal": bool(torch.equal(cpu_t[2], t_outs[2])),
        "loc_mask_equal": bool(torch.equal(cpu_t[1], t_outs[1])),
        "loc_target_max_rel_err": _rel(cpu_t[0].numpy(), card[0])}
    check(res["target_on_card_inputs"]["cls_target_equal"]
          and res["target_on_card_inputs"]["loc_mask_equal"]
          and res["target_on_card_inputs"]["loc_target_max_rel_err"] <= 1e-5,
          f"MultiBoxTarget on the CPU on the card's inputs gives the card's "
          f"targets ({res['target_on_card_inputs']})")
    # the CPU's own targets (from its own class scores) against the card's:
    # a sample may differ only where its mining boundary is within twice
    # the devices' probability gap
    own = [t.numpy() for t in rec["cpu"][0]]
    delta = res["cls_prob_max_abs_err"]
    gaps = _mining_gap(_softmax_np(t_ins[2].numpy()), t_ins[0].numpy(), y)
    differ, ok = _targets_part_at_ties(own, card, gaps, 2 * delta)
    res["own_targets"] = {"samples_differ": differ, "mining_gaps": gaps,
                          "prob_delta": delta}
    print("  (b) SSD targets card vs CPU: "
          + json.dumps({k: res[k] for k in ("target_on_card_inputs",
                                            "own_targets")}), flush=True)
    check(ok, "the CPU's own targets equal the card's, but in samples whose "
          f"mining boundary is a near-tie ({res['own_targets']})")
    res["detection"] = det_detect_card_vs_cpu(mx, trained, x)
    return res


class Overlaps:
    """While installed, keeps (on the CPU) every overlap matrix that the
    IoU function ``name`` of ``module`` returns; with ``given`` (another
    run's matrices), returns those in turn in place of its own: NMS then
    takes that run's decisions."""

    def __init__(self, module, name, given=None):
        self.module, self.name, self.given = module, name, given
        self.fn = getattr(module, name)
        self.own = []

    def __enter__(self):
        def kept(*a):
            iou = self.fn(*a)
            self.own.append(iou.detach().cpu())
            if self.given is None:
                return iou
            return self.given[len(self.own) - 1].to(iou.device, iou.dtype)

        setattr(self.module, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


# the overlap function and threshold each NMS op decides on
NMS_OVERLAPS = {"MultiBoxDetection": ("contrib_det", "_iou_matrix",
                                      "nms_threshold", 0.5),
                "Proposal": ("rcnn", "_iou_matrix_plus1", "threshold", 0.7)}


def _rows_differ(op_name, got, want):
    """The output rows of ``op_name`` that differ: a class id or score
    that is not equal, or a box off by more than 1e-5 (MultiBoxDetection,
    (B, A, 6)); a batch index that is not equal, or a box off by more than
    1e-5 of the largest coordinate (Proposal, (R, 5))."""
    if op_name == "MultiBoxDetection":
        return (got[..., :2] != want[..., :2]).any(-1) \
            | (np.abs(got[..., 2:] - want[..., 2:]) > 1e-5).any(-1)
    scale = max(1.0, float(np.abs(want[:, 1:]).max()))
    return (got[:, 0] != want[:, 0]) \
        | (np.abs(got[:, 1:] - want[:, 1:]) > 1e-5 * scale).any(-1)


def nms_card_vs_cpu(op_name, attrs, ins):
    """``op_name`` (MultiBoxDetection or Proposal) on the numpy ``ins`` on
    the card, on the CPU, and on the CPU on the card's overlap matrices.
    The two devices' overlaps can fall on opposite sides of the NMS
    threshold (their roundings differ), and only those pairs may decide a
    row differently. Held: the CPU on the card's overlaps gives the card's
    output (class ids, scores and batch indices exact, boxes within 1e-5),
    and every row in which the CPU's own output differs from the card's is
    one that the card's overlaps change on the CPU, i.e. one that the
    pairs on opposite sides decide. Returns (card output, report, held)."""
    import importlib

    import torch

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    mod_name, iou_name, key, default = NMS_OVERLAPS[op_name]
    module = importlib.import_module("mxnet_tpu_torch.ops." + mod_name)
    thresh = float(attrs.get(key, default))
    fn = get_op(op_name).fn

    def run(dev, given=None):
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in ins]
        with Overlaps(module, iou_name, given) as ov:
            out = fn(OpCtx(device=torch.device(dev)), dict(attrs), *ts)
        return out.cpu().numpy(), ov.own

    card, card_iou = run("cuda")
    own, cpu_iou = run("cpu")
    shared, _ = run("cpu", given=card_iou)
    opposite = sum(int(((g > thresh) != (c > thresh)).sum())
                   for g, c in zip(card_iou, cpu_iou))
    differ = _rows_differ(op_name, card, own)
    decided = _rows_differ(op_name, shared, own)
    res = {"overlaps_opposite_sides": opposite,
           "overlap_max_abs_err": max(float((g - c).abs().max())
                                      for g, c in zip(card_iou, cpu_iou)),
           "rows": int(differ.size), "rows_differ": int(differ.sum()),
           "rows_decided_by_opposite_pairs": int(decided.sum()),
           "on_card_overlaps_rows_differ": int(
               _rows_differ(op_name, card, shared).sum())}
    if op_name == "MultiBoxDetection":
        res["detections"] = int((card[..., 0] >= 0).sum())
        res["boxes_max_abs_err"] = float(np.abs(card[..., 2:]
                                                - own[..., 2:]).max())
    else:
        res["rois_max_rel_err"] = _rel(card[:, 1:], own[:, 1:])
    ok = res["on_card_overlaps_rows_differ"] == 0 \
        and len(card_iou) == len(cpu_iou) > 0 \
        and not (differ & ~decided).any()
    return card, res, ok


def det_detect_card_vs_cpu(mx, weights, x):
    """The detection graph at ``weights`` on the card and on the CPU. Held:
    the graph's inputs to MultiBoxDetection (class probabilities and box
    offsets) within 1e-4 on the two devices, and MultiBoxDetection on the
    CPU on the card's inputs against the card's (B, A, 6) output as
    :func:`nms_card_vs_cpu` holds it. The two graphs' own outputs are
    compared row by row and reported: they part where the inputs' gap
    moves a score by more than 1e-5 or across a decision."""
    from mxnet_tpu_torch.examples.ssd import symbol as ssd_symbol
    from mxnet_tpu_torch.ops import get_op

    sym = ssd_symbol.get_ssd_detect(2)
    op = get_op("MultiBoxDetection")
    fn = op.fn
    ins, outs = {}, {}
    for key, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        def kept(octx, attrs, *a, key=key):
            ins[key] = ([t.detach().cpu().numpy() for t in a], dict(attrs))
            return fn(octx, attrs, *a)

        args = {n: mx.nd.array(weights[n], ctx)
                for n in sym.list_arguments() if n != "data"}
        op.fn = kept
        try:
            outs[key] = sym.eval(ctx=ctx, data=mx.nd.array(x, ctx),
                                 **args)[0].asnumpy()
        finally:
            op.fn = fn
    (g_in, attrs), (c_in, _) = ins["gpu"], ins["cpu"]
    g, c = outs["gpu"], outs["cpu"]
    card, shared, ok = nms_card_vs_cpu("MultiBoxDetection", attrs, g_in)
    graph_rows = _rows_differ("MultiBoxDetection", g, c)
    res = {"inputs": {"cls_prob_max_abs_err": float(np.abs(g_in[0]
                                                           - c_in[0]).max()),
                      "loc_pred_max_abs_err": float(np.abs(g_in[1]
                                                           - c_in[1]).max())},
           "op_on_card_inputs": shared,
           "op_rerun_equals_graph": bool(np.array_equal(card, g)),
           "graphs": {"rows": int(graph_rows.size),
                      "detections": [int((g[..., 0] >= 0).sum()),
                                     int((c[..., 0] >= 0).sum())],
                      "rows_differ": int(graph_rows.sum()),
                      "class_ids_differ": int((g[..., 0] != c[..., 0]).sum()),
                      "scores_differ_over_1e-5": int(
                          (np.abs(g[..., 1] - c[..., 1]) > 1e-5).sum()),
                      "score_max_abs_err": float(np.abs(g[..., 1]
                                                        - c[..., 1]).max()),
                      "boxes_max_abs_err": float(np.abs(g[..., 2:]
                                                        - c[..., 2:]).max())}}
    print("  (b) SSD detection graph card vs CPU: " + json.dumps(res),
          flush=True)
    check(res["inputs"]["cls_prob_max_abs_err"] <= 1e-4
          and res["inputs"]["loc_pred_max_abs_err"] <= 1e-4,
          "SSD's detection graph: MultiBoxDetection's inputs on the card "
          f"within 1e-4 of the CPU's ({res['inputs']})")
    check(ok and res["op_rerun_equals_graph"] and shared["detections"] > 0,
          "SSD's detection graph: MultiBoxDetection on the CPU on the card's "
          "inputs gives the card's output, but in rows that overlaps on "
          f"opposite sides of the NMS threshold decide ({shared})")
    return res


def det_rcnn(mx, seed):
    """(c) ``train_faster_rcnn.train_and_eval`` at its test's arguments on
    the card and its gate; the step's ms split into the Custom op's host
    time (its forward, and its backward with the forward it runs again)
    and the rest; the rule that refused the capture; then
    ``rcnn_toy.py`` to its own assertion."""
    from mxnet_tpu_torch import operator as toperator
    from mxnet_tpu_torch.examples.rcnn import rcnn_toy
    from mxnet_tpu_torch.examples.rcnn import train_faster_rcnn as frcnn

    fn = toperator._CustomFunction
    fwd, bwd = fn.forward, fn.backward
    host = {"forward": 0.0, "backward": 0.0}
    calls = {"forward": 0, "backward": 0}

    def clocked(key, f):
        def run(*a):
            calls[key] += 1
            t = time.perf_counter()
            try:
                return f(*a)
            finally:
                host[key] += (time.perf_counter() - t) * 1e3
        return staticmethod(run)

    custom = []
    fn.forward, fn.backward = clocked("forward", fwd), clocked("backward",
                                                               bwd)
    t0 = time.perf_counter()
    try:
        with StepClock(mx, then=lambda: custom.append(dict(host))) as clock:
            acc, miou = frcnn.train_and_eval(
                ctx=mx.gpu(0),
                log=lambda m: print("  (c) " + m, flush=True), **DET_RCNN)
    finally:
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
    secs = time.perf_counter() - t0
    stamps, infos = clock.stamps, clock.infos
    step_ms = np.diff(stamps) * 1e3
    c_fwd = np.diff([c["forward"] for c in custom])
    c_bwd = np.diff([c["backward"] for c in custom])
    steady = slice(2, None)
    info = infos[-1]
    out = {"accuracy": acc, "mean_iou": miou, "seconds": secs,
           "steps": len(stamps),
           "steady_step_ms": float(np.median(step_ms[steady])),
           "custom_forward_ms": float(np.median(c_fwd[steady])),
           "custom_backward_ms": float(np.median(c_bwd[steady])),
           "rest_ms": float(np.median((step_ms - c_fwd - c_bwd)[steady])),
           # the backward runs only where an input of the op needs a
           # gradient: its ROIs and boxes need none
           "custom_calls": calls, "step": info}
    print(f"  (c) Faster R-CNN: {json.dumps(out)}", flush=True)
    check(acc >= DET_RCNN_GATE["accuracy"]
          and miou >= DET_RCNN_GATE["mean_iou"],
          f"Faster R-CNN accuracy {acc:.3f} >= 0.8 and mean IoU "
          f"{miou:.3f} >= 0.5")
    check(info is not None and not info["captured"]
          and "Custom node" in (info["refusal"] or ""),
          f"Faster R-CNN's step refused capture for its Custom node "
          f"({info and info['refusal']})")
    t0 = time.perf_counter()
    toy = rcnn_toy.main([], log=lambda m: print("  (c) rcnn_toy " + m,
                                                flush=True))
    out["rcnn_toy"] = {"accuracy": toy, "seconds": time.perf_counter() - t0}
    check(toy > 0.8, f"rcnn_toy.py's ROI accuracy {toy:.3f} > 0.8")
    return out


def _voc_labels(rng, b, g):
    """(B, G, 5) VOC-like rows: 1 to G/2 boxes of 20 classes a sample,
    padded with -1."""
    lab = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(rng.integers(1, g // 2 + 1)):
            x0, y0 = rng.uniform(0, 0.7, 2)
            w, h = rng.uniform(0.05, 0.3, 2)
            lab[i, j] = [rng.integers(0, 20), x0, y0, x0 + w, y0 + h]
    return lab


def _ssd300_anchors(mx):
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    import torch

    prior = get_op("MultiBoxPrior")
    return torch.cat([prior.fn(OpCtx(), {"sizes": s, "ratios": r},
                               torch.zeros(1, 1, m, m))
                      for m, s, r in SSD300_MAPS], dim=1).numpy()


def det_op_cases(mx, seed):
    """(d)'s cases: (name, op, attrs, numpy inputs, differentiate)."""
    from mxnet_tpu_torch.examples.rcnn import train_faster_rcnn as frcnn

    rng = np.random.default_rng(seed + 170)
    anchors = _ssd300_anchors(mx)
    na = anchors.shape[1]
    check(na == 8732, f"SSD-300's priors: {na} == 8732 anchors")
    b, c = SSD300_BATCH, SSD300_CLASSES
    logits = rng.standard_normal((b, c, na), dtype=np.float32) * 2
    cases = [
        ("MultiBoxTarget SSD-300", "MultiBoxTarget",
         {"overlap_threshold": 0.5, "negative_mining_ratio": 3},
         [anchors, _voc_labels(rng, b, SSD300_GT), logits], False),
        ("MultiBoxDetection SSD-300", "MultiBoxDetection",
         {"nms_threshold": 0.45, "nms_topk": 400, "threshold": 0.01},
         [_softmax_np(logits).astype(np.float32),
          (rng.standard_normal((b, na * 4), dtype=np.float32) * 0.5),
          anchors], False)]
    fh, fw = VGG_RPN_MAP
    k = 9
    rpn = rng.standard_normal((1, 2, k, fh, fw), dtype=np.float32)
    cases.append(("Proposal VGG-16 600x1000", "Proposal", {},
                  [_softmax_np(rpn).reshape(1, 2 * k, fh, fw)
                   .astype(np.float32),
                   rng.standard_normal((1, 4 * k, fh, fw),
                                       dtype=np.float32) * 0.1,
                   np.array([[600, 1000, 1.0]], np.float32)], False))
    # two images a batch, the second smaller (its own clip and minimum
    # size), so that the batch index and each image's NMS are held too
    r2 = np.random.default_rng(seed + 171)
    rpn = r2.standard_normal((2, 2, k, fh, fw), dtype=np.float32)
    cases.append(("Proposal VGG-16 600x1000 batch 2", "Proposal", {},
                  [_softmax_np(rpn).reshape(2, 2 * k, fh, fw)
                   .astype(np.float32),
                   r2.standard_normal((2, 4 * k, fh, fw),
                                      dtype=np.float32) * 0.1,
                   np.array([[600, 1000, 1.0], [540, 900, 0.9]],
                            np.float32)], False))
    # the examples' shapes: Faster R-CNN's test graph (batch 4) and
    # heads, and rcnn_toy's
    frpn = rng.standard_normal((4, 2, frcnn.K, frcnn.FEAT, frcnn.FEAT),
                               dtype=np.float32)
    cases.append(("Proposal Faster R-CNN example", "Proposal",
                  dict(feature_stride=frcnn.STRIDE, scales=frcnn.SCALES,
                       ratios=frcnn.RATIOS, rpn_pre_nms_top_n=200,
                       rpn_post_nms_top_n=frcnn.POST_NMS, threshold=0.7,
                       rpn_min_size=6),
                  [_softmax_np(frpn).reshape(4, 2 * frcnn.K, frcnn.FEAT,
                                             frcnn.FEAT).astype(np.float32),
                   rng.standard_normal((4, 4 * frcnn.K, frcnn.FEAT,
                                        frcnn.FEAT), dtype=np.float32) * 0.2,
                   np.tile(np.array([frcnn.IMG, frcnn.IMG, 1.0], np.float32),
                           (4, 1))], False))
    for name, n, ch, hw, r, pooled, scale in (
            ("ROIPooling Faster R-CNN example", 4, 32, frcnn.FEAT, 64,
             (6, 6), 1.0 / frcnn.STRIDE),
            ("ROIPooling rcnn_toy", 16, 32, 24, 128, (4, 4), 0.5)):
        img = hw / scale
        x0 = rng.uniform(0, img * 0.7, (r, 2))
        wh = rng.uniform(4, img * 0.5, (r, 2))
        rois = np.concatenate([rng.integers(0, n, (r, 1)), x0,
                               np.minimum(x0 + wh, img - 1)], 1)
        cases.append((name, "ROIPooling",
                      {"pooled_size": pooled, "spatial_scale": scale},
                      [np.maximum(rng.standard_normal((n, ch, hw, hw),
                                                      dtype=np.float32), 0),
                       rois.astype(np.float32)], True))
    return cases


def det_ops(mx, seed):
    """(d) each op alone at the published and the examples' shapes, card
    against CPU on the same inputs, with its time on the card (per call
    and on the device alone). MultiBoxTarget's class ids, masks and targets
    must match exactly, but in samples whose mining boundary is within
    1e-6; MultiBoxDetection and Proposal as :func:`nms_card_vs_cpu` holds
    them; ROIPooling's forward exactly, its gradient within 1e-5."""
    import torch

    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops.registry import OpCtx

    out = {}
    for name, op_name, attrs, ins, diff in det_op_cases(mx, seed):
        op = get_op(op_name)
        res = {}
        if op_name in NMS_OVERLAPS:
            _, held, ok = nms_card_vs_cpu(op_name, attrs, ins)
            res.update(held)
        ts = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
              for a in ins]
        if diff:
            ts[0].requires_grad_(True)
        ctx = OpCtx(is_train=diff, device=torch.device("cuda"))

        def call(ts=ts, ctx=ctx):
            return op.fn(ctx, dict(attrs), *ts)

        # a call queues 20-70 kernels: 4 calls a round stay within the
        # card's queue of pending launches, which blocks the host when full
        res["ms"] = time_cuda(call)
        res["device_ms"] = time_device(call, reps=DET_OP_REPS)
        if op_name == "MultiBoxTarget":
            g, c = ([t.cpu().numpy() for t in
                     op.fn(OpCtx(device=torch.device(dev)), dict(attrs),
                           *[torch.from_numpy(np.ascontiguousarray(a))
                             .to(dev) for a in ins])]
                    for dev in ("cuda", "cpu"))
            res["cls_target_differ"] = int((g[2] != c[2]).sum())
            res["loc_mask_differ"] = int((g[1] != c[1]).sum())
            res["loc_target_max_rel_err"] = _rel(g[0], c[0])
            gaps = _mining_gap(_softmax_np(ins[2]), ins[0], ins[1])
            res["min_mining_gap"] = min(x for x in gaps if x is not None)
            res["samples_differ"], ok = _targets_part_at_ties(g, c, gaps,
                                                              1e-6)
        elif op_name == "ROIPooling":
            head = np.random.default_rng(seed).standard_normal(
                tuple(call().shape), dtype=np.float32)
            runs = {}
            for dev in ("cuda", "cpu"):
                t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in ins]
                t[0].requires_grad_(True)
                o = op.fn(OpCtx(is_train=True, device=torch.device(dev)),
                          dict(attrs), *t)
                grad, = torch.autograd.grad(o, t[0],
                                            torch.from_numpy(head).to(dev))
                runs[dev] = (o.detach().cpu().numpy(), grad.cpu().numpy())

            def fwd_bwd(ts=ts, ctx=ctx,
                        head=torch.from_numpy(head).to("cuda")):
                torch.autograd.grad(op.fn(ctx, dict(attrs), *ts), ts[0],
                                    head)

            res["fwd_bwd_device_ms"] = time_device(fwd_bwd,
                                                   reps=DET_OP_REPS)
            (g, g_grad), (c, c_grad) = runs["cuda"], runs["cpu"]
            res["max_rel_err"] = _rel(g, c)
            res["grad_max_rel_err"] = _rel(g_grad, c_grad)
            ok = res["max_rel_err"] == 0.0 and res["grad_max_rel_err"] <= 1e-5
        res["shapes"] = [list(a.shape) for a in ins]
        print(f"  (d) {name}: {json.dumps(res)}", flush=True)
        check(ok, f"{name}: card vs CPU ({res})")
        out[name] = res
    # the masked ROIPooling's values at VGG-16's shapes (300 ROIs, 7 x 7
    # bins, 512 x 38 x 63 features): what it would hold
    r, (ph, pw), (c, h, w) = 300, (7, 7), (512,) + VGG_RPN_MAP
    elems = r * ph * pw * c * h * w
    out["roi_pooling_vgg16_masked_values"] = {
        "elements": elems, "fp32_gb": elems * 4 / 1e9}
    print(f"  (d) ROIPooling's masked form at VGG-16's shapes would hold "
          f"{elems} values ({elems * 4 / 1e9:.1f} GB in fp32)", flush=True)
    return out


def phase_detection(mx, seed):
    """Object detection: (a) SSD through evaluate.py and train.py, (b) its
    step card vs CPU, (c) Faster R-CNN and rcnn_toy.py, (d) the ops
    alone."""
    print("phase 15: object detection", flush=True)
    t0 = time.perf_counter()
    out, trained = det_ssd(mx, seed)
    out = {"ssd": out}
    out["ssd_card_vs_cpu"] = det_card_vs_cpu(mx, seed, trained)
    out["faster_rcnn"] = det_rcnn(mx, seed)
    out["ops"] = det_ops(mx, seed)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 15: {out['seconds']:.1f} s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import mxnet_tpu_torch as mx

    t_start = time.perf_counter()
    card = phase_device()
    build = phase_build()
    cases = phase_kernel_vs_plain(args.seed)
    slice_out, weights, probs = phase_slice(mx, LAYERS, args.seed)
    parity = phase_card_vs_cpu(mx, weights, args.seed)
    rtc_cases = phase_rtc_vs_plain(args.seed)
    imperative = phase_imperative(mx, weights, probs, args.seed)
    amp = phase_amp(mx, weights, args.seed)
    ptb_split = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec") as rec_dir:
        # phases 9-12 measure the split path that PRs 7-10 recorded
        os.environ["MXTPU_NO_FUSED_STEP"] = "1"
        try:
            train = phase_train(mx, weights, args.seed)
            fit = phase_fit(mx, args.seed)
            records = phase_records(mx, args.seed, rec_dir)
            ptb = phase_ptb(mx, args.seed, ptb_split)
        finally:
            os.environ.pop("MXTPU_NO_FUSED_STEP")
        graph = phase_step_graph(mx, weights, args.seed, records["rec"],
                                 ptb_split, train["mean_nll"])
        zoo = phase_zoo(mx, args.seed, rec_dir)
    detection = phase_detection(mx, args.seed)

    main_case = cases["slice_fp32_causal"]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:47",
        # the captured requests' launches are the kernels the card ran in
        # them (traced); the wrapper's calls are the warm-up's and the
        # capture's
        "launches": slice_out["launches"],
        "launches_by_path": {
            "requests_traced": slice_out["launches"],
            "requests_wrapper_calls": slice_out["wrapper_calls"]},
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "device_ms": main_case["device_ms"],
        "library_device_ms": main_case["library_device_ms"],
    }]
    tc_case = cases["slice_bf16_causal"]
    kernels.append({
        "name": "flash_attention_fwd_tc",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd_tc.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:47",
        # the captured steps' launches are the kernels the card ran in them
        # (traced); the wrapper's calls there are the warm-up's and the
        # capture's
        "launches": amp["launches"] + train["launches"]
        + graph["lm"]["launches"],
        "launches_by_path": {
            "amp_requests_traced": amp["launches"],
            "amp_requests_wrapper_calls": amp["wrapper_calls"]["bfloat16"],
            "training_steps": train["launches"],
            "captured_training_steps_traced": graph["lm"]["launches"],
            "captured_training_steps_wrapper_calls":
                graph["lm"]["wrapper_calls"]["bfloat16"]},
        **{k: tc_case[k] for k in KERNEL_KEYS}})
    for name, case in (("rtc_axpy", "axpy_logits_fp32"),
                       ("rtc_sgd_mom", "sgd_mom_embedding_fp32")):
        row = rtc_cases[case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/rtc_examples.py",
            "replaces": "mxnet_tpu/rtc.py:41",
            "launches": imperative["launches"][name],
            **{k: row[k] for k in KERNEL_KEYS}})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build": build, "cases": cases,
                   "slice": slice_out, "card_vs_cpu": parity,
                   "rtc_cases": rtc_cases, "imperative": imperative,
                   "amp": amp, "train": train, "fit": fit,
                   "records": records, "ptb": ptb, "step_graph": graph,
                   "zoo": zoo, "detection": detection,
                   "kernels": kernels,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
