#!/usr/bin/env python
"""The multi-card paths of the port against one card (or, with ``--cpu``,
``cpu(i)`` contexts and gloo against one context):

1. ``dist_sync_kvstore.py`` as N workers through ``tools/launch.py``, one
   card each over NCCL (the nightly asserts);
2. ``dist_lenet.py`` as N workers on unshuffled shards against one process
   over N contexts (``--as-one N``): the workers' weights equal, and the
   largest gap to the one process;
3. a Convolution + BatchNorm + FullyConnected + SoftmaxOutput net over N
   contexts against one, fp32, 3 SGD-momentum steps: the largest gap of
   the weights, moving statistics and outputs;
4. ResNet-``--layers`` (the split path, SGD with momentum) over N contexts
   against one after 1 and ``--steps`` steps, in fp32 and under bf16 amp:
   the worst arrays (gap over the array's max-abs), the same for two runs
   on one context (determinism) and for one context from weights moved by
   1e-7 of themselves (how far rounding alone carries the run: ResNet-50
   from random weights on random labels is that sensitive), with the
   steps' wall ms.

It prints one JSON line (on the cards also to
``chiprun_out/multi_card.json``). ``--trace`` runs instead one steady
ResNet step of each type over one context and over N
(:func:`trace`: host ms of the step's parts, each card's busy ms and
kernels, the copies, the runtime's synchronising calls), to
``chiprun_out/multi_card_trace.json``.
On a host with 4 cards: ``python3 mxnet_tpu_torch/tools/
multi_card_check.py``; on the CPU: ``python mxnet_tpu_torch/tools/
multi_card_check.py --cpu --cards 2``.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402

TOOLS = os.path.join(ROOT, "mxnet_tpu_torch", "tools")
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _run(cmd, timeout=600):
    return subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


def workers(n, cpu):
    flag = ["--cpu"] if cpu else []
    r = _run([sys.executable, os.path.join(ROOT, "tools", "launch.py"),
              "-n", str(n), "--port", _free_port(), "--", sys.executable,
              os.path.join(TOOLS, "dist_sync_kvstore.py"), *flag])
    return {"rc": r.returncode,
            "ok": r.stdout.count("dist_sync_kvstore OK"),
            "backends": sorted(set(ln.split("backend=")[-1] for ln in
                                   r.stdout.splitlines() if "backend=" in ln))}


def lenet(n, cpu):
    flag = ["--cpu"] if cpu else []
    with tempfile.TemporaryDirectory() as tmp:
        r = _run([sys.executable, os.path.join(ROOT, "tools", "launch.py"),
                  "-n", str(n), "--port", _free_port(), "--",
                  sys.executable, os.path.join(TOOLS, "dist_lenet.py"),
                  *flag, "--no-shuffle", "--save", tmp])
        one = _run([sys.executable, os.path.join(TOOLS, "dist_lenet.py"),
                    *flag, "--no-shuffle", "--save", tmp, "--as-one",
                    str(n)])
        if r.returncode or one.returncode:
            return {"rc": [r.returncode, one.returncode],
                    "stderr": (r.stderr + one.stderr)[-2000:]}
        ws = [np.load(os.path.join(tmp, f"rank{i}.npz")) for i in range(n)]
        w = np.load(os.path.join(tmp, "one.npz"))
        return {"rc": [0, 0],
                "workers_equal": all(np.array_equal(ws[0][k], x[k])
                                     for x in ws for k in w),
                "vs_one_process_max_abs": max(
                    float(np.abs(ws[0][k] - w[k]).max()) for k in w)}


def _bound(sym, ctxs, data_shape, classes, weights, steps, amp=None):
    """A Module over ``ctxs`` with ``weights`` and SGD, and ``steps``
    batches of random data and labels."""
    batches = [mx.io.DataBatch(
        [mx.nd.array(np.random.RandomState(i).standard_normal(data_shape)
                     .astype(np.float32), ctxs[0])],
        [mx.nd.array(np.random.RandomState(i).randint(
            0, classes, data_shape[0]).astype(np.float32), ctxs[0])])
        for i in range(steps)]
    mod = mx.mod.Module(sym, context=ctxs, amp=amp)
    mod.bind([("data", data_shape)], [("softmax_label", data_shape[:1])])
    mod.init_params(
        arg_params={k: mx.nd.array(v, ctxs[0]) for k, v in weights[0].items()},
        aux_params={k: mx.nd.array(v, ctxs[0]) for k, v in weights[1].items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return mod, batches


def _train(sym, ctxs, data_shape, classes, weights, steps, amp=None):
    mod, batches = _bound(sym, ctxs, data_shape, classes, weights, steps,
                          amp)
    ms = []
    for b in batches:
        t0 = time.perf_counter()
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        out = mod.get_outputs()[0].asnumpy()   # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in {**args, **auxs}.items()}, out, ms


def _weights(sym, data_shape, seed=5):
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=data_shape, softmax_label=data_shape[:1])
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        z = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("_gamma"):
            args[name] = 1.0 + 0.1 * z
        elif name.endswith(("_beta", "_bias")):
            args[name] = 0.02 * z
        else:
            args[name] = z * np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
    aux = {name: (np.ones(shape, np.float32) if name.endswith("_var")
                  else np.zeros(shape, np.float32))
           for name, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _worst(got, want, top=4):
    return sorted(((float(np.abs(got[k] - want[k]).max()
                          / max(float(np.abs(want[k]).max()), 1e-30)), k)
                   for k in want), reverse=True)[:top]


def bn_net(n, make):
    d = mx.sym.Variable("data")
    c = mx.sym.Convolution(d, kernel=(3, 3), num_filter=8, name="conv")
    b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(b), num_hidden=5, name="fc"), name="softmax")
    shape = (16, 3, 8, 8)
    w = _weights(net, shape)
    one, o1, _ = _train(net, [make(0)], shape, 5, w, 3)
    many, on, _ = _train(net, [make(i) for i in range(n)], shape, 5, w, 3)
    return {"max_abs": max(float(np.abs(many[k] - one[k]).max())
                           for k in one),
            "outputs_max_abs": float(np.abs(on - o1).max())}


def resnet(n, make, layers, px, batch, steps, amp):
    sym, classes = _resnet_sym(layers, px)
    shape = (batch, 3, px, px)
    w = _weights(sym, shape)
    out = {}
    noise = np.random.default_rng(7)
    moved = ({k: (v * (1 + 1e-7 * noise.standard_normal(v.shape)))
              .astype(np.float32) for k, v in w[0].items()}, w[1])
    for k in sorted({1, steps}):
        one, _, ms1 = _train(sym, [make(0)], shape, classes, w, k, amp)
        again, _, _ = _train(sym, [make(0)], shape, classes, w, k, amp)
        near, _, _ = _train(sym, [make(0)], shape, classes, moved, k, amp)
        many, _, msn = _train(sym, [make(i) for i in range(n)], shape,
                              classes, w, k, amp)
        out[f"steps_{k}"] = {"n_vs_1": _worst(many, one),
                             "1_vs_1": _worst(again, one),
                             "moved_1e-7_vs_1": _worst(near, one),
                             "ms_1": ms1, f"ms_{n}": msn}
    return out


def _resnet_sym(layers, px):
    classes = 1000 if px >= 224 else 10
    return mx.models.resnet.get_symbol(
        num_classes=classes, num_layers=layers,
        image_shape=f"3,{px},{px}"), classes


def _step_parts(mod, b):
    """One split-path step; the host ms of forward, backward, update and
    the wait for the outputs, and the step's wall ms."""
    t = [time.perf_counter()]
    mod.forward(b, is_train=True)
    t.append(time.perf_counter())
    mod.backward()
    t.append(time.perf_counter())
    mod.update()
    t.append(time.perf_counter())
    mod.get_outputs()[0].asnumpy()
    t.append(time.perf_counter())
    parts = {k: (t[i + 1] - t[i]) * 1e3 for i, k in
             enumerate(("forward", "backward", "update", "wait"))}
    parts["step"] = (t[-1] - t[0]) * 1e3
    return parts


def _clocked_step(mod, b):
    """:func:`_step_parts`, with the host ms inside the replicas' forward
    walk (``Executor._walk_replicas``) and autograd's backward
    (``torch.autograd.grad``) added as ``walk`` and ``autograd``."""
    import torch

    from mxnet_tpu_torch import executor as texe

    inner = {"walk": 0.0, "autograd": 0.0}

    def clocked(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                inner[key] += (time.perf_counter() - t) * 1e3
        return run

    walk, grad = texe.Executor._walk_replicas, torch.autograd.grad
    texe.Executor._walk_replicas = clocked("walk", walk)
    torch.autograd.grad = clocked("autograd", grad)
    try:
        parts = _step_parts(mod, b)
    finally:
        texe.Executor._walk_replicas, torch.autograd.grad = walk, grad
    parts.update(inner)
    return parts


def trace(n, make, layers, px, batch, amp, warm=2):
    """One steady split-path step of ResNet-``layers`` over one context
    and over ``n`` at the same global batch: the host ms of each part of the
    step (:func:`_clocked_step`, untraced), then under the profiler each
    card's busy ms (the sum of its kernels and copies) and kernel count,
    the copies by kind (count, ms), and the host ms inside the CUDA
    runtime's synchronising calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sym, classes = _resnet_sym(layers, px)
    shape = (batch, 3, px, px)
    w = _weights(sym, shape)
    out = {}
    for k in (1, n):
        mod, batches = _bound(sym, [make(i) for i in range(k)], shape,
                              classes, w, warm + 2, amp)
        for b in batches[:warm]:
            _step_parts(mod, b)
        host = _clocked_step(mod, batches[warm])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = _step_parts(mod, batches[warm + 1])
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        busy, kernels, copies, syncs = {}, {}, {}, [0, 0.0]
        for e in prof.events():
            ms = (e.time_range.end - e.time_range.start) / 1e3
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue
                d = str(e.device_index)
                busy[d] = busy.get(d, 0.0) + ms
                if "Memcpy" in e.name or "Memset" in e.name:
                    c = copies.setdefault(e.name, [0, 0.0])
                    c[0] += 1
                    c[1] += ms
                else:
                    kernels[d] = kernels.get(d, 0) + 1
            elif e.name.startswith("cuda") and (
                    "Synchronize" in e.name or e.name.startswith(
                        ("cudaMemcpy", "cudaStreamWaitEvent"))):
                syncs[0] += 1
                syncs[1] += ms
        out[f"cards_{k}"] = {
            "host_ms": host, "traced_host_ms": traced, "busy_ms": busy,
            "kernels": kernels, "copies": copies,
            "runtime_sync_calls": syncs[0], "runtime_sync_ms": syncs[1]}
        del mod, batches
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="cpu(i) contexts and gloo, at small sizes")
    ap.add_argument("--cards", type=int, default=None,
                    help="contexts and workers (default: every card; 2 "
                         "with --cpu)")
    ap.add_argument("--layers", type=int, default=None,
                    help="ResNet depth (50 on the cards, 8 with --cpu)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", action="store_true",
                    help="only the ResNet steps' breakdown (trace) over "
                         "one context and over every one (on the cards "
                         "also to chiprun_out/multi_card_trace.json)")
    args = ap.parse_args(argv)
    import torch

    if args.cpu:
        n, make = args.cards or 2, mx.cpu
        layers, px, batches = args.layers or 8, 32, {None: 16, "bfloat16": 16}
        device = {"platform": "cpu", "count": n}
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        n, make = args.cards or torch.cuda.device_count(), mx.gpu
        layers, px = args.layers or 50, 224
        batches = {None: 64, "bfloat16": 256}
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        device = {"platform": "gpu", "count": n,
                  "cards": smi.stdout.strip().splitlines()[:n]}
    out = {"device": device, "contexts": n}
    if not args.trace:
        out["workers"] = workers(n, args.cpu)
        out["lenet"] = lenet(n, args.cpu)
    # one context would take the fused step: both sides take the split path
    saved = os.environ.get("MXTPU_NO_FUSED_STEP")
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"
    try:
        if not args.trace:
            out["bn_net"] = bn_net(n, make)
        for amp, batch in batches.items():
            out[f"resnet{layers}_{amp or 'float32'}_b{batch}"] = (
                trace(n, make, layers, px, batch, amp) if args.trace else
                resnet(n, make, layers, px, batch, args.steps, amp))
    finally:
        if saved is None:
            os.environ.pop("MXTPU_NO_FUSED_STEP")
        else:
            os.environ["MXTPU_NO_FUSED_STEP"] = saved
    name = "multi_card_trace.json" if args.trace else "multi_card.json"
    return _report(out, None if args.cpu else name)


def _report(out, name):
    """Print ``out`` as one JSON line, and write it to
    ``chiprun_out/<name>`` unless ``name`` is None."""
    line = json.dumps(out)
    if name:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
