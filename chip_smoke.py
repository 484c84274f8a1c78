#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``--parity`` only builds the kernels and holds each against its plain
version, forward and backward, the first call to make after a kernel
changes; ``--trace`` runs only the ``[trace]`` phase; ``--kernel-times 1,128,256,2560`` also times every block's
forward and backward kernels at those batches and prints them as one JSON
line, to compare two source trees in one call.)

It builds every kernel of the port's paths from ``distributed_ba3c_tpu_torch``'s
sources (``csrc/conv_block.cu``, the forward; ``csrc/conv_block_bwd.cu``, the
backward's route, dgrad and wgrad), holds each against its plain PyTorch
version at the shapes the paths give it (the backward per block under each
tie rule the model runs it with -- flax's on every block, reference_block's
on blocks 1-3 -- on tie and random inputs at every batch of ``BWD_BATCHES``, and twice
for bit-equal gradients), then drives the paths through the entry points a
user calls: ``BA3CNet`` at full width (84x84x4 uint8 frames, convs
32/32/64/64, FC 512, 6 actions, seeded random weights) on native Pong
frames, ``BatchedPredictor`` serving block and single-row requests,
``python -m distributed_ba3c_tpu_torch --task play``, ``--task train
--trainer tpu_fused_ba3c --env jax:pong`` (128 envs x 20 steps per update,
the learner through the conv-block kernels forward and backward, under the
default ``block_rules="xla"``), and ``[resume]``: a run kept in checkpoints,
resumed with ``--load`` under a ``hyper.txt`` learning rate of 0, and
evaluated and played with ``--load``; and ``[sync]``: ``--task train
--trainer tpu_sync_ba3c`` (the JAX CLI's default) with 4 native Pong env
servers of 16 envs over the block-shm wire, the batched predictor serving
them, and the learner at B=128, for 2 epochs, then a ``--load`` resume,
then 8 python FakeEnv simulators over the per-env wire with the greedy
Evaluator; ``[vtrace]``: ``--trainer tpu_vtrace_ba3c`` on the same plane
(5-step segments with the served log-probs, 25 a learner step, one
forward over 150 states), 2 epochs and a ``--load`` epoch; and
``[overlap]``: ``--trainer tpu_fused_ba3c --overlap`` (the actor on its
own CUDA stream beside the learner, lag 1, one learner forward over 2688
states), 2 epochs and a ``--load`` epoch, lag 0 at learning rate 0
bit-equal with the fused step, and ``probe_overlap``; and ``[games]``:
the seven other on-device games stepped on the card and on the CPU from
the same draws (equal frames, rewards, dones and state), BASELINE config
#5 (``--env jax:coinrun --batch_size 20480 --rollout_len 20 --gamma
0.999``: 1024 envs, learner chunks of 4096) for 2 epochs, a ``--load``
epoch and ``--task eval --load`` through host players, one fused epoch of
each other game with its docs/RECIPES.md flags, and the sync trainer on
16 ``jax:breakout`` host players whose children never initialize CUDA;
and ``[trace]``: the telemetry plane -- the sync trainer with
``--trace_sample 8 --telemetry_port`` scraped over HTTP while it runs
(complete causal chains env_step -> learner_step, hop histograms,
``/trace`` through ``scripts/trace_dump.py``, each hop's median and p99),
a traced V-trace epoch, the tracing overhead on the plane alone, a
``torch.profiler`` capture of two annotated learner steps whose kernel
events match the launch counters, a SIGTERM flight dump, and the fused
trainer's scrape endpoint, TensorBoard events and channels.
The kernels' parity covers the V-trace and overlap learners' batches
(150, 2688) and CoinRun's (1024, 4096). An
``[env]`` line first records which of pyzmq, msgpack, tensorboard and
gymnasium the machine has (informational).
Every phase must pass; any failure exits nonzero and prints no result.

The last lines of standard output are: the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), one JSON object with each kernel's launches on the driven paths,
error against the plain version, times and bound, and last
``{"ok": true, "device": {...}}``. Times are CUDA-event times on this card,
after a warmup; the bound is the larger of the bytes the function must move
over 3.35 TB/s and its bf16 operations over 989 TFLOP/s (H100 SXM data
sheet, dense, at 700 W). The operations are those of the pre-pool
positions the output needs (``needed_flops``): a 2x2 pool of 21 rows drops
the 21st, which the kernel never computes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 256                    # the serving bucket the predictor runs at
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
REL_TOL = 2e-2             # max|d| / max|ref| (tests/test_pallas_conv.py:63)
GRAD_REL_L2 = 2e-2         # per leaf, kernel-forward vs plain-forward gradients
TRAIN_B = 2560             # one learner chunk: 128 envs x 20 rollout steps
TRAIN_ENVS, TRAIN_T = 128, 20
ULP_SHARE = 0.999          # elements within one bf16 ulp of the plain version
WARMUP_BUCKETS = B.bit_length()  # pow-2 buckets 1..B that warmup() runs


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` between two CUDA events. The queue is
    drained first: work still queued (a learner's backward) would let the
    host enqueue every timed call ahead of the card, and host-bound calls
    would read as their device time alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the hand-written kernels' symbols, as a capture names them (mangled or
#: not): a kernel event is filed under the first that its name contains
OWN_KERNELS = ("wgrad_reduce_kernel", "wgrad_kernel", "dgrad_kernel", "route_kernel",
               "conv_block_kernel")


def kernel_name(name: str) -> str:
    """A kernel event's name, short: the hand-written kernel's symbol, or a
    library kernel's name cut before its template and argument lists."""
    own = next((k for k in OWN_KERNELS if k in name), None)
    return own or name.split("(")[0].split("<")[0].strip()[:80]


def device_times(fns: dict, iters: int = 5, warmup: int = 2, attempts: int = 4) -> dict:
    """Each function's device time from one ``torch.profiler`` capture (the
    CUPTI path ``[trace]`` uses): ``{name: {"device_ms": kernel time per
    call, "by_kernel": {kernel: ms per call}}}``. After a warmup, and an
    untimed first range in the capture (CUPTI can drop a capture's first
    kernels), each function runs ``iters`` times inside its own
    ``record_function`` range, the queue drained between ranges; a kernel
    counts towards the range its launch call lies in, or, without a launch
    record, the range that began last before it ran. Host issue is left
    out, which CUDA events around the calls (:func:`time_ms`) include when
    the host is slower than the card. A capture in which a function shows
    no kernel is taken again, up to ``attempts`` captures; a function still
    without one gets ``device_ms`` None, logged."""
    out = None
    for attempt in range(attempts):
        out = _device_times_once(fns, iters, warmup)
        empty = [name for name, v in out.items() if not v["by_kernel"]]
        if not empty:
            return out
        log(f"[device-times] no kernel event in capture {attempt + 1} for {empty}")
    for v in out.values():
        if not v["by_kernel"]:
            v["device_ms"] = None
    return out


def _device_times_once(fns: dict, iters: int, warmup: int) -> dict:
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("device_times:"):  # untimed
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
        for name, fn in fns.items():
            with record_function(f"device_times:{name}"):
                for _ in range(iters):
                    fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"].split(":", 1)[1]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("device_times:"))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {name: {"device_ms": 0.0, "by_kernel": {}} for name in fns}
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is not None:  # the range its launch call lies in
            owner = next((r for lo, hi, r in ranges if lo <= t <= hi), None)
        else:  # no launch record (CUPTI drops some): the queue is drained
            # between ranges, so the range that began last before it ran
            owner = next((r for lo, _, r in reversed(ranges) if lo <= e["ts"]), None)
        if owner not in out:  # outside the ranges, or the untimed one
            continue
        ms = e["dur"] / 1e3 / iters
        by = out[owner]["by_kernel"]
        k = kernel_name(e.get("name", ""))
        by[k] = by.get(k, 0.0) + ms
        out[owner]["device_ms"] += ms
    return out


def _ms(v) -> str:
    """A time for a log line: ms to 4 places, or "n/a" where none was taken."""
    return "n/a" if v is None else f"{v:.4f}"


def bf16_ulp_share(got, ref) -> float:
    """Share of elements whose difference is at most one bf16 ulp of the
    larger magnitude of the two."""
    import torch

    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - r).abs() <= ulp).float().mean())


def phase_build():
    """Build the kernels (one nvcc per source, all at once) beside the
    native env core."""
    from distributed_ba3c_tpu_torch.ops import _build

    t0 = time.perf_counter()
    make = subprocess.Popen(
        ["make", "-C", os.path.join(ROOT, "cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        _build.build_all(KERNEL_SOURCES)
    finally:
        out, _ = make.communicate()
    if make.returncode != 0:
        raise RuntimeError(f"make -C cpp failed:\n{out}")
    log(f"[build] kernels + native core built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            # per instantiation: its name, registers, shared memory and
            # spills (the dynamic shared memory is chosen at launch)
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                log(f"[build] {name} ptxas: {line.strip()}")


KERNEL_SOURCES = ("conv_block", "conv_block_bwd")
# B=1 and 3 catch ragged-edge and tail faults; 128 is the sync learner's
# batch, 150 the V-trace learner's (25 segments x 5 + 25 bootstrap states),
# 2688 the overlap learner's (128 envs x 20 + 128 bootstrap states), 1024
# CoinRun's rollout forward and 4096 its learner chunk (BASELINE config #5)
KERNEL_BATCHES = (1, 3, 128, 150, B, 1024, TRAIN_B, 2688, 4096)
BWD_BATCHES = (1, 3, 128, 150, 1024, TRAIN_B, 2688, 4096)
DZ_MISMATCH = 1e-3  # share of dz elements the route may route otherwise than cuDNN's z
TIMED_BATCHES = (B, 1024, TRAIN_B, 4096)


def needed_flops(s) -> int:
    """Multiply-adds (2 operations each) of the pre-pool positions one
    sample's output needs: 2*Ho x 2*Wo when pooled (block 2's 21 x 21
    conv feeds a 10 x 10 pool, so 20 x 20 of it), all H x W when not."""
    u = 2 if s.pool else 1
    return 2 * (s.Ho * u) * (s.Wo * u) * s.Co * s.kh * s.kw * s.Ci


def kernel_cases():
    """(name, spec) of every block geometry: block 0 as the frames take it
    (uint8) and as the model path gives it (bf16 /255), then blocks 1-3."""
    from distributed_ba3c_tpu_torch.ops.conv_block import ba3c_specs

    specs = ba3c_specs()
    return [("block0_uint8", specs[0])] + [
        (f"block{i}", dataclasses.replace(s, scale_uint8=False))
        for i, s in enumerate(specs)
    ]


def phase_kernels(dev, batches=KERNEL_BATCHES, timed_batches=TIMED_BATCHES):
    """Each conv block geometry at B in ``batches``: the kernel against its
    plain version on the same seeded inputs; at B in ``timed_batches`` also
    the times of kernel, plain version and one library computation of the
    same function, with the achieved TFLOP/s and the share of the bound.
    Returns {B: [row per block]} for the timed batches, and the largest
    max|d| of every check."""
    import torch
    import torch.nn.functional as F

    from distributed_ba3c_tpu_torch.ops.conv_block import conv_block_fwd, reference_block

    g = torch.Generator().manual_seed(0)
    cases = kernel_cases()
    params = [
        ((torch.randn((s.kh, s.kw, s.Ci, s.Co), generator=g) * 0.1).to(torch.bfloat16).to(dev),
         (torch.randn((s.Co,), generator=g) * 0.05).to(torch.bfloat16).to(dev))
        for _, s in cases
    ]
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.bfloat16, device=dev)
    out, worst = {}, 0.0
    for nb in batches:
        gd = torch.Generator(device=dev).manual_seed(nb)
        frames = torch.randint(0, 256, (nb, 84, 84 * 4), generator=gd, device=dev,
                               dtype=torch.uint8)
        x_bf16 = frames.to(torch.bfloat16) / 255.0
        rows, prev = [], None
        for (name, s), (w, b) in zip(cases, params):
            # block0 takes the frames (uint8, or bf16 /255 as on the model
            # path); each later block takes the previous block's plain output
            x = {"block0_uint8": frames, "block0": x_bf16}.get(name, prev)
            got = conv_block_fwd(x, w, b, s)
            ref = reference_block(x, w, b, s)
            prev = ref
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            share = bf16_ulp_share(got, ref)
            worst = max(worst, err)
            ok = (got.shape == ref.shape and err / max(scale, 1e-6) < REL_TOL
                  and share >= ULP_SHARE)
            log(
                f"[kernel] {name} B={nb}: {s.H}x{s.W}x{s.Ci}->{s.Co} k{s.kh} pool={s.pool} "
                f"max|d|={err:.6g} max|ref|={scale:.6g} rel={err / max(scale, 1e-6):.3e} "
                f"within-1-ulp={share:.6f} {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(
                    f"conv_block_fwd disagrees with reference_block on {name} at B={nb}")
            if nb not in timed_batches:
                continue

            # the library's computation of the same function: conv2d + relu +
            # max_pool2d in bf16 on a channels-last NCHW view, timed here only
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            x4 = x.reshape(nb, s.H, s.W, s.Ci).permute(0, 3, 1, 2)
            pad = (s.pw, s.kw - 1 - s.pw, s.ph, s.kh - 1 - s.ph)

            def library(x4=x4, w_oihw=w_oihw, b=b, s=s, pad=pad):
                xi = x4.to(torch.bfloat16) * inv255 if s.scale_uint8 else x4
                y = F.relu(F.conv2d(F.pad(xi, pad), w_oihw, b))
                return F.max_pool2d(y, 2) if s.pool else y

            lib_out = library()
            lib_err = float((lib_out.permute(0, 2, 3, 1).reshape(got.shape).float()
                             - ref.float()).abs().max())
            n_bytes = (x.numel() * x.element_size() + w.numel() * 2 + b.numel() * 2
                       + got.numel() * 2)
            n_ops = nb * needed_flops(s)
            before = conv_block_fwd.launches
            iters = 20 if nb <= B else 5
            row = {
                "block": name,
                "shape": [nb, s.H, s.W, s.Ci, s.Co, s.kh, int(s.pool)],
                "max_abs_err": err,
                "rel_err": err / max(scale, 1e-6),
                "within_1_ulp": share,
                "ms": time_ms(lambda: conv_block_fwd(x, w, b, s), iters=iters),
                "plain_ms": time_ms(lambda: reference_block(x, w, b, s), iters=iters),
                "library_ms": time_ms(library, iters=iters),
                "library_max_abs_err": lib_err,
                **bound(n_bytes, n_ops),
            }
            conv_block_fwd.launches = before  # comparison launches do not count
            row["tflops"] = n_ops / row["ms"] / 1e9
            row["bound_share"] = row["bound_ms"] / row["ms"]
            log(
                f"[kernel] {name} B={nb}: kernel {row['ms']:.4f} ms "
                f"({row['tflops']:.2f} TFLOP/s, {100 * row['bound_share']:.2f}% of bound), "
                f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            )
            rows.append(row)
        if rows:
            out[nb] = rows
    return out, worst


def bwd_inputs(s, nb, kind, dev, seed):
    """Seeded inputs of one block's backward: x, w, b and the cotangent g.
    ``ties``: frames that are 0 outside a band of rows and a few pixels,
    every other bias 0 and the rest positive, a sparse +-1 cotangent; many
    pre-activations are then exactly 0 and many windows tied, where the
    two tie rules differ. ``random``: |N(0, 0.5)| inputs, normal biases and
    cotangent."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nb, s.H, s.W, s.Ci), generator=g).abs() * 0.5
    w = torch.randn((s.kh, s.kw, s.Ci, s.Co), generator=g) * 0.1
    b = torch.randn((s.Co,), generator=g) * 0.05
    gy = torch.randn((nb, s.Ho, s.Wo * s.Co), generator=g)
    if kind == "ties":
        keep = torch.rand((nb, s.H, s.W, 1), generator=g) < 0.01
        keep[:, s.H // 3: s.H // 3 + 3] = True
        x = x * keep
        b[::2] = 0.0
        b[1::4] = b[1::4].abs()
        gy = torch.sign(gy) * (torch.rand(gy.shape, generator=g) < 0.1)
    bf = lambda t: t.to(torch.bfloat16).to(dev).contiguous()
    return bf(x.reshape(nb, s.H, s.W * s.Ci)), bf(w), bf(b), bf(gy)


def _abs(a, r) -> float:
    return float((a.float() - r.float()).abs().max())


def _rel(a, r) -> float:
    return _abs(a, r) / max(float(r.float().abs().max()), 1e-6)


def rounding_flips(x, w, b, s, dz, dz_ref, plain):
    """(n, explained): the n elements of dz that the kernel routes otherwise
    than the plain block, and whether each sits where two f32 orders of the
    conv sum may round the pre-activation z to either side of a routing
    decision. The test is on the exact sum: acc, the conv of the samples
    with a flip in float64 (bf16 products, so exact but for the last
    bits), and delta = 16 * 2^-24 * sum|x w|, many times the error of
    either f32 order. z_lo and z_hi are z rounded as the block rounds it
    (bf16(bf16(acc -+ delta) + b)). An element is explained when
    ``plain``'s relu gate (flax: z > 0; reference_block: the sign of z)
    differs between z_lo and z_hi, or, in a pooled block, when its window's
    choice can change: two or more of the window's relu(z) can reach its
    largest and one of those can move. A z that is exactly 0, or a window
    tied exactly, with no rounding edge within delta, is not explained:
    there the tie rule alone decides."""
    import torch

    from distributed_ba3c_tpu_torch.ops.conv_block import _conv, flax_block

    off = (dz != dz_ref).permute(0, 3, 1, 2)
    n = int(off.sum())
    if n == 0:
        return 0, True
    rows = off.flatten(1).any(1).nonzero().flatten()
    off = off[rows]
    Hd, Wd = dz.shape[1:3]
    xs = x[rows]
    if s.scale_uint8:  # the blocks' input: uint8 times bf16(1/255), rounded once
        xs = xs.to(torch.bfloat16) * torch.tensor(1.0 / 255.0, dtype=torch.bfloat16,
                                                  device=xs.device)
        s = dataclasses.replace(s, scale_uint8=False)
    acc = _conv(xs, w, s, torch.float64)[:, :, :Hd, :Wd]
    delta = 16 * 2.0 ** -24 * _conv(xs.abs(), w.abs(), s, torch.float64)[:, :, :Hd, :Wd]
    bb = b.to(torch.bfloat16)[:, None, None]

    def z_of(a):
        return (a.float().to(torch.bfloat16) + bb).float()

    z_lo, z_hi = z_of(acc - delta), z_of(acc + delta)
    gate = (lambda z: z > 0) if plain is flax_block else torch.sign  # noqa: E731
    near = gate(z_lo) != gate(z_hi)
    if s.pool:
        def windows(t):  # [r, Co, Hd, Wd] -> [r, Co, Hd/2, Wd/2, 4]
            r, c = t.shape[:2]
            return (t.reshape(r, c, Hd // 2, 2, Wd // 2, 2).permute(0, 1, 2, 4, 3, 5)
                    .reshape(r, c, Hd // 2, Wd // 2, 4))

        r_lo, r_hi = windows(torch.relu(z_lo)), windows(torch.relu(z_hi))
        top = r_hi >= r_lo.amax(-1, keepdim=True)  # can reach the window's largest
        moves = top & (r_lo != r_hi)
        ambiguous = (top.sum(-1) >= 2) & moves.any(-1)
        up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
        near |= up(ambiguous)
    return n, bool(near[off].all())


def phase_bwd_kernels(dev, batches=BWD_BATCHES):
    """Each block's backward under each tie rule it runs with (bwd_cases)
    at B in ``batches``, on tie and random inputs:
    the conv_block Function's gradients (the route, dgrad and wgrad kernels)
    against the plain block's VJP, dx, dw and db each within REL_TOL of
    max|ref|; each kernel against its plain version on the same inputs; two
    identical backward calls bit-equal. On tie inputs the route's dz must
    equal the plain block's exactly. On random inputs it may differ at a
    few elements (DZ_MISMATCH at most), each of which must be a rounding
    flip (:func:`rounding_flips`), and a gradient that then leaves REL_TOL
    of the plain VJP must be within REL_TOL of the plain pieces on the
    kernel's own routing (dgrad_plain and wgrad_plain of its dz): under
    flax's rule a flipped relu gate moves a whole cotangent, under
    reference_block's half of one. At each batch also block 0's wgrad on
    uint8 frames (:func:`bwd_uint8_wgrad`). Returns each
    kernel's largest max|d| against its plain version (the route's: in
    dz)."""
    import torch

    from distributed_ba3c_tpu_torch.ops.conv_block import (
        conv_block,
        conv_block_bwd,
        conv_block_dgrad,
        conv_block_route,
        conv_block_wgrad,
        dgrad_plain,
        route_plain,
        wgrad_plain,
    )

    saved = launch_counts()
    worst = {"route": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    for nb in batches:
        for i, s, plain, x_grad in bwd_cases():
            for kind in ("ties", "random"):
                x, w, b, gy = bwd_inputs(s, nb, kind, dev, seed=100 * i + nb)
                grads = []
                for fn in (lambda *a: conv_block(*a, s, plain), lambda *a: plain(*a, s)):
                    leaves = [x.detach().requires_grad_(x_grad), w.detach().requires_grad_(True),
                              b.detach().requires_grad_(True)]
                    fn(*leaves).backward(gy)
                    grads.append([t.grad for t in leaves if t.grad is not None])
                dz, dbpart = conv_block_route(x, w, b, gy, s, plain)
                dz_ref, dbpart_ref = route_plain(x, w, b, gy, s, plain)
                again = conv_block_bwd(x, w, b, gy, s, plain, (x_grad, True, True))
                first = conv_block_bwd(x, w, b, gy, s, plain, (x_grad, True, True))
                torch.cuda.synchronize()
                names = (["dx"] if x_grad else []) + ["dw", "db"]
                rel = {n: _rel(a, r) for n, a, r in zip(names, *grads)}
                dz_off = float((dz != dz_ref).float().mean())
                flips, explained = rounding_flips(x, w, b, s, dz, dz_ref, plain)
                routed = {}
                if (kind == "random" and flips and explained
                        and not all(rel[n] < REL_TOL for n in names)):
                    # the plain pieces on the kernel's routing
                    on_dz = ([dgrad_plain(dz, w, s)] if x_grad else []) + list(
                        wgrad_plain(x, dz, dbpart, s))
                    routed = {n: _rel(a, r) for n, a, r in zip(names, grads[0], on_dz)}
                    rel.update({f"{n} on kernel dz": v for n, v in routed.items()})
                checks = {f"vjp {n}": rel[n] < REL_TOL or routed.get(n, 1.0) < REL_TOL
                          for n in names}
                rel["route db"] = _rel(dbpart.sum(0), dbpart_ref.sum(0))
                worst["route"] = max(worst["route"], _abs(dz, dz_ref))
                if kind == "ties":
                    # the tie rule alone decides here: dz must be the plain route's
                    checks["route dz equal"] = flips == 0
                else:
                    checks["route dz"] = dz_off <= DZ_MISMATCH
                    checks["route flips at rounding"] = explained
                checks["route db"] = rel["route db"] < REL_TOL
                if x_grad:
                    dx, dx_ref = conv_block_dgrad(dz, w, s), dgrad_plain(dz, w, s)
                    rel["dgrad"] = _rel(dx, dx_ref)
                    checks["dgrad"] = rel["dgrad"] < REL_TOL
                    worst["dgrad"] = max(worst["dgrad"], _abs(dx, dx_ref))
                dw, db = conv_block_wgrad(x, dz, dbpart, s)
                dw_ref, db_ref = wgrad_plain(x, dz, dbpart, s)
                rel["wgrad dw"], rel["wgrad db"] = _rel(dw, dw_ref), _rel(db, db_ref)
                checks["wgrad"] = rel["wgrad dw"] < REL_TOL and rel["wgrad db"] < REL_TOL
                worst["wgrad"] = max(worst["wgrad"], _abs(dw, dw_ref), _abs(db, db_ref))
                checks["bit-equal rerun"] = all(
                    (a is None and c is None) or torch.equal(a, c) for a, c in zip(first, again))
                ok = all(checks.values())
                log(f"[bwd] block{i} ({plain.__name__}) B={nb} {kind}: "
                    + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
                    + f" route flips={flips} dz-mismatch={dz_off:.2e}"
                    + (f" ({flips} elements, {'each a rounding flip' if explained else 'NOT at rounding'})"
                       if flips else "") + (" ok" if ok else
                    " FAIL " + ",".join(k for k, v in checks.items() if not v)))
                if not ok:
                    raise AssertionError(f"conv_block backward disagrees on block{i} B={nb} {kind}")
                del grads, dz, dz_ref, again, first
        bwd_uint8_wgrad(dev, nb, worst)
    set_launch_counts(saved)  # comparison launches do not count
    return worst


def bwd_uint8_wgrad(dev, nb: int, worst: dict) -> None:
    """Block 0's route and wgrad on uint8 frames (the kernels scale them by
    bf16(1/255) as they lay their halos out): the route's dz against
    route_plain's under :func:`phase_bwd_kernels`' rule for random inputs,
    the wgrad against its plain version on the route's own dz, within
    REL_TOL, and a rerun bit-equal."""
    import torch

    from distributed_ba3c_tpu_torch.ops.conv_block import (
        ba3c_specs,
        conv_block_route,
        conv_block_wgrad,
        flax_block,
        route_plain,
        wgrad_plain,
    )

    s = ba3c_specs()[0]
    g = torch.Generator().manual_seed(nb)
    x = torch.randint(0, 256, (nb, s.H, s.W * s.Ci), generator=g, dtype=torch.uint8).to(dev)
    _, w, b, gy = bwd_inputs(s, nb, "random", dev, seed=nb)
    dz, dbpart = conv_block_route(x, w, b, gy, s, flax_block)
    dw, db = conv_block_wgrad(x, dz, dbpart, s)
    again = conv_block_wgrad(x, dz, dbpart, s)
    dw_ref, db_ref = wgrad_plain(x, dz, dbpart, s)
    dz_ref, _ = route_plain(x, w, b, gy, s, flax_block)
    torch.cuda.synchronize()
    flips, explained = rounding_flips(x, w, b, s, dz, dz_ref, flax_block)
    rel = {"wgrad dw": _rel(dw, dw_ref), "wgrad db": _rel(db, db_ref)}
    equal = torch.equal(dw, again[0]) and torch.equal(db, again[1])
    routed = explained and flips <= DZ_MISMATCH * dz.numel()
    ok = all(v < REL_TOL for v in rel.values()) and equal and routed
    worst["route"] = max(worst["route"], _abs(dz, dz_ref))
    worst["wgrad"] = max(worst["wgrad"], _abs(dw, dw_ref), _abs(db, db_ref))
    log(f"[bwd] block0_uint8 (flax_block) B={nb} random: "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items())
        + f" route flips={flips}" + (" (each a rounding flip)" if flips and explained else "")
        + (" ok" if ok else " FAIL" + ("" if equal else " rerun not bit-equal")
           + ("" if routed else " route dz")))
    if not ok:
        raise AssertionError(f"block 0's uint8 route or wgrad disagrees at B={nb}")


def bwd_calls(x, w, b, gy, s, plain, x_grad: bool):
    """One block's backward pieces as timed calls on the same inputs: the
    route, wgrad and (where x takes a gradient) dgrad wrappers, and the
    library's call of the same functions (``aten.convolution_backward``
    for the weight and bias gradient and for the input gradient; the
    route has none). The library's inputs are laid out outside the calls:
    NCHW views of the channels-last data, x padded SAME and cut to dz's
    grid."""
    import torch

    from distributed_ba3c_tpu_torch.ops.conv_block import (
        _conv_input,
        conv_block_dgrad,
        conv_block_route,
        conv_block_wgrad,
    )

    dz, dbpart = conv_block_route(x, w, b, gy, s, plain)
    Hd, Wd = dz.shape[1:3]
    x_nchw = _conv_input(x, s, torch.bfloat16)[:, :, : Hd + s.kh - 1, : Wd + s.kw - 1]
    x_nchw = x_nchw.contiguous(memory_format=torch.channels_last)
    dz_nchw = dz.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library_bwd(mask):
        return torch.ops.aten.convolution_backward(
            dz_nchw, x_nchw, w_oihw, [s.Co], [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)

    calls = {"route": lambda: conv_block_route(x, w, b, gy, s, plain),
             "wgrad": lambda: conv_block_wgrad(x, dz, dbpart, s),
             "library wgrad": lambda: library_bwd([False, True, True])}
    if x_grad:
        calls["dgrad"] = lambda: conv_block_dgrad(dz, w, s)
        calls["library dgrad"] = lambda: library_bwd([True, False, False])
    return dz, dbpart, calls


def route_bound(x, w, b, gy, s, nb: int) -> dict:
    """:func:`bound` of one route call: x, w, b and g read once and dz
    written once; the operations of the pre-pool positions dz holds."""
    Hd, Wd = (2 * s.Ho, 2 * s.Wo) if s.pool else (s.H, s.W)
    n_dz = 2 * nb * Hd * Wd * s.Co
    n_bytes = x.numel() * x.element_size() + 2 * (w.numel() + b.numel() + gy.numel()) + n_dz
    return bound(n_bytes, nb * needed_flops(s))


def phase_bwd_times(dev, nb: int) -> dict:
    """Each backward kernel's time per block at batch ``nb`` on random
    inputs, and the library's for the same function: {block: {call:
    {"ms": CUDA events around the wrapper, "device_ms": the profiler's
    kernel time, "by_kernel": ...}}}; the route's also with its bound
    (:func:`route_bound`) and its device time's share of it."""
    saved = launch_counts()
    out = {}
    for i, s, plain, x_grad in vjp_cases():
        x, w, b, gy = bwd_inputs(s, nb, "random", dev, seed=i)
        _, _, calls = bwd_calls(x, w, b, gy, s, plain, x_grad)
        dev_t = device_times(calls)
        out[f"block{i}"] = {k: {"ms": time_ms(fn, iters=10), **dev_t[k]} for k, fn in calls.items()}
        route = out[f"block{i}"]["route"]
        route.update(route_bound(x, w, b, gy, s, nb))
        route["bound_share"] = (None if route["device_ms"] is None
                                else route["bound_ms"] / route["device_ms"])
        log(f"[kernel-times] block{i} backward at B={nb}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (device {_ms(v['device_ms'])})"
            for k, v in out[f"block{i}"].items())
            + f"; route bound {route['bound_ms']:.4f} ms ({route['bound_by']}), "
            + ("share not measured" if route["bound_share"] is None
               else f"{100 * route['bound_share']:.1f}% of it on device time"))
    set_launch_counts(saved)
    return out


def vjp_cases(rules: str = "xla"):
    """(index, spec, plain, x takes a gradient) of each block as the model
    runs it under ``block_rules=rules``: block 0 on bf16 frames / 255 with
    no input gradient; every block with flax's rules under "xla" (the
    trainer's), blocks 1-3 with reference_block's under "pallas"."""
    from distributed_ba3c_tpu_torch.ops.conv_block import (
        ba3c_specs,
        flax_block,
        reference_block,
        supported,
    )

    pallas = rules == "pallas"
    return [(i, dataclasses.replace(s0, scale_uint8=False),
             reference_block if pallas and supported(s0) else flax_block, i > 0)
            for i, s0 in enumerate(ba3c_specs())]


def bwd_cases():
    """Every (block, tie rule) the model runs: the four blocks under flax's
    rule, and blocks 1-3 under reference_block's too."""
    from distributed_ba3c_tpu_torch.ops.conv_block import reference_block

    return vjp_cases("xla") + [c for c in vjp_cases("pallas") if c[2] is reference_block]


def pong_states(n_blocks: int, n_envs: int = 64, seed: int = 0):
    """``n_blocks`` blocks of [n_envs, 84, 84, 4] uint8 states from the
    native Pong core, frame-stacked x4, stepped with seeded random actions."""
    import numpy as np

    from distributed_ba3c_tpu_torch.envs.native import CppBatchedEnv

    env = CppBatchedEnv("pong", n_envs, seed=seed)
    rng = np.random.default_rng(seed)
    hist = [env.reset().copy()] * 4
    blocks = []
    for i in range(n_blocks * 8 + 16):
        obs, _, _ = env.step(rng.integers(0, env.num_actions, n_envs).astype(np.int32))
        hist = hist[1:] + [obs.copy()]
        if i >= 16 and i % 8 == 0:
            blocks.append(np.stack(hist, axis=-1))
    env.close()
    return blocks[:n_blocks], env.num_actions


def phase_model(dev, states):
    """BA3CNet through the kernel against BA3CNet through the plain
    version, same seeded params, same Pong frames, on the card."""
    import numpy as np
    import torch

    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    nets = {
        backend: BA3CNet(
            num_actions=6, conv_backend=backend, device=dev,
            generator=torch.Generator().manual_seed(0),
        )
        for backend in ("cuda", "torch")
    }
    x = torch.from_numpy(np.concatenate(states[:4])).to(dev)  # [256, 84, 84, 4]
    with torch.inference_mode():
        out = {k: m(x) for k, m in nets.items()}
        torch.cuda.synchronize()
        got, ref = out["cuda"], out["torch"]
        for field in ("logits", "value"):
            a, r = getattr(got, field).float(), getattr(ref, field).float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"model {field} not finite")
            err = float((a - r).abs().max())
            scale = float(r.abs().max())
            log(f"[model] {field}: max|d|={err:.6g} scale={scale:.6g} rel={err / max(scale, 1e-6):.3e}")
            if err > REL_TOL * max(scale, 1e-6):
                raise AssertionError(f"model {field}: kernel path disagrees with plain path")
        band = REL_TOL * float(ref.logits.abs().max())
        top2 = torch.topk(ref.logits, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > band
        same = got.logits.argmax(-1) == ref.logits.argmax(-1)
        log(f"[model] greedy actions equal on {int(same[clear].sum())}/{int(clear.sum())} rows with margin > {band:.3g}")
        if not bool(same[clear].all()):
            raise AssertionError("greedy actions differ where the margin is clear")
        fwd = {k: time_ms(lambda m=m: m(x), iters=10) for k, m in nets.items()}
    log(f"[model] forward at B={x.shape[0]}: conv_backend=cuda {fwd['cuda']:.4f} ms, "
        f"conv_backend=torch {fwd['torch']:.4f} ms")
    return nets["cuda"], fwd


def phase_serving(dev, model, states, num_actions):
    """BatchedPredictor at batch_size 256, dispatch depth 2: four threads of
    64-state blocks and one thread of single rows with a 50 ms deadline."""
    import numpy as np

    from distributed_ba3c_tpu_torch import telemetry
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor, ShedReject

    telemetry.reset_all()
    pred = BatchedPredictor(model, model.state_dict(), batch_size=B, dispatch_depth=2,
                            seed=0, device=dev)
    t0 = time.perf_counter()
    pred.warmup(states[0].shape[1:])
    log(f"[serve] warmup of {WARMUP_BUCKETS} buckets in {time.perf_counter() - t0:.2f} s")
    pred.start()
    n_block_threads, blocks_per_thread, n_rows = 4, 60, 300
    lock = threading.Lock()
    served, shed, bad = [], [], []
    done = threading.Event()
    expected = n_block_threads * blocks_per_thread + n_rows

    def resolved(kind, t_submit, payload=None, reject=None):
        now = time.perf_counter()
        with lock:
            if reject is not None:
                shed.append(reject)
                if not isinstance(reject, ShedReject) or reject.reason not in (
                    "deadline", "queue_full", "shutdown"
                ):
                    bad.append(f"untyped shed {reject!r}")
            else:
                actions, values = payload
                if not (np.all((actions >= 0) & (actions < num_actions))
                        and np.all(np.isfinite(values))):
                    bad.append(f"{kind}: actions {actions} values {values}")
                served.append((kind, now - t_submit, np.size(actions)))
            if len(served) + len(shed) == expected:
                done.set()

    def block_client(tid):
        # closed loop, as an env server steps: the next block of states
        # goes out when the last block's actions came back
        for i in range(blocks_per_thread):
            t = time.perf_counter()
            back = threading.Event()
            pred.put_block_task(
                states[(tid + i) % len(states)],
                lambda a, v, lp, t=t, e=back: (resolved("block", t, (a, v)), e.set()),
                shed_callback=lambda r, t=t, e=back: (resolved("block", t, reject=r), e.set()),
            )
            if not back.wait(timeout=120):
                raise TimeoutError(f"block client {tid}: request {i} never resolved")

    def row_client():
        for i in range(n_rows):
            t = time.perf_counter()
            pred.put_task(
                states[i % len(states)][i % states[0].shape[0]],
                lambda a, v, lp, t=t: resolved("row", t, (np.asarray(a), np.asarray(v))),
                deadline=pred._clock() + 0.050,
                shed_callback=lambda r, t=t: resolved("row", t, reject=r),
            )
            time.sleep(0.002)

    errors = []

    def guarded(fn, *args):
        try:
            fn(*args)
        except Exception as e:  # surfaced below: a client that died fails the phase
            errors.append(repr(e))
            done.set()

    threads = [threading.Thread(target=guarded, args=(block_client, k))
               for k in range(n_block_threads)]
    threads.append(threading.Thread(target=guarded, args=(row_client,)))
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    ok = done.wait(timeout=300) and not errors
    wall = time.perf_counter() - t0
    pred.stop()
    pred.join(timeout=10)
    if not ok:
        raise AssertionError(
            f"only {len(served) + len(shed)}/{expected} requests resolved; "
            f"client errors: {errors}"
        )
    if bad:
        raise AssertionError(f"bad results: {bad[:3]}")
    tele = telemetry.registry("predictor").scalars()
    rows = sum(n for _, _, n in served)
    lat = np.array([dt for _, dt, _ in served]) * 1e3
    row_lat = np.array([dt for k, dt, _ in served if k == "row"]) * 1e3
    stats = {
        "requests": expected,
        "served": len(served),
        "shed": len(shed),
        "shed_reasons": sorted({r.reason for r in shed}),
        "rows_served": rows,
        "wall_s": wall,
        "rows_per_s": rows / wall,
        "served_p50_ms": float(np.percentile(lat, 50)),
        "served_p99_ms": float(np.percentile(lat, 99)),
        "row_p50_ms": float(np.percentile(row_lat, 50)) if row_lat.size else None,
        "row_p99_ms": float(np.percentile(row_lat, 99)) if row_lat.size else None,
        "batches": int(tele.get("batches_total", 0)),
        "mean_batch_rows": tele.get("rows_total", 0) / max(tele.get("batches_total", 1), 1),
        "deadline_misses": int(tele.get("deadline_misses_total", 0)),
    }
    log(f"[serve] {json.dumps(stats)}")
    return stats


def phase_play(dev):
    """The CLI entry point: greedy play of native Pong through predict_batch."""
    from distributed_ba3c_tpu_torch.cli import main as cli_main

    rc = cli_main(["--task", "play", "--env", "cpp:pong", "--nr_eval", "1",
                   "--max_steps", "300", "--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"--task play returned {rc}")


def pong_train_states(dev, n_envs: int = TRAIN_ENVS, steps: int = TRAIN_T, seed: int = 0):
    """[n_envs * steps, 84, 84, 4] uint8 frame stacks of the port's device
    Pong stepped with seeded random actions: one learner chunk's states."""
    from distributed_ba3c_tpu_torch.envs.jaxenv import pong

    return game_train_states(pong, dev, n_envs, steps, seed)


def game_train_states(env, dev, n_envs: int, steps: int, seed: int = 0):
    """[n_envs * steps, 84, 84, 4] uint8 frame stacks of an on-device game
    stepped with seeded random actions, after 8 warm-up steps."""
    import torch

    from distributed_ba3c_tpu_torch.fused.loop import initial_stack, push_frame, device_draws

    draws = device_draws(env, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(draws.reset_noise(n_envs, dev))
    stack = initial_stack(env, state, 4)
    out = []
    for _ in range(steps + 8):
        a = torch.randint(0, env.num_actions, (n_envs,), generator=g, device=dev,
                          dtype=torch.int32)
        state, obs, _, done = env.step(state, a, draws.env_noise(n_envs, dev))
        stack = push_frame(stack, obs, done)
        out.append(stack)
    return torch.cat(out[-steps:])


def phase_vjp(dev, states, rules: str = "xla", detail: bool = True):
    """The conv_block Function (kernel forward; backward the route, dgrad
    and wgrad kernels) per block at B = len(states) (2560, the fused
    learner chunk; 128, the sync learner's batch; 4096, CoinRun's chunk),
    as the learner runs it under ``block_rules=rules``, against the plain
    block under autograd on the same inputs (within REL_TOL, or, where a
    gradient leaves it, with :func:`phase_bwd_kernels`' rounding-flip rule),
    with its time; with ``detail`` also the times of the plain
    block and of the library's F.conv2d + relu + F.max_pool2d under
    autograd, then each backward kernel alone against its plain version and
    one library call of the same function (aten.convolution_backward for
    the dgrad and the wgrad; the route has none)."""
    import torch
    import torch.nn.functional as F

    from distributed_ba3c_tpu_torch.ops.conv_block import (
        conv_block,
        conv_block_route,
        dgrad_plain,
        route_plain,
        wgrad_plain,
    )

    nb = states.shape[0]
    g = torch.Generator().manual_seed(1)
    x = (states.reshape(nb, 84, 84 * 4).to(torch.bfloat16) / 255.0).contiguous()
    rows = []
    saved = launch_counts()
    for i, s, plain, x_grad in vjp_cases(rules):
        w = (torch.randn((s.kh, s.kw, s.Ci, s.Co), generator=g) * 0.1).to(torch.bfloat16).to(dev)
        b = (torch.randn((s.Co,), generator=g) * 0.05).to(torch.bfloat16).to(dev)
        gy = torch.randn((nb, s.Ho, s.Wo * s.Co), generator=g).to(torch.bfloat16).to(dev)

        def run(fn, x=x, w=w, b=b, gy=gy, x_grad=x_grad):
            leaves = [x.detach().requires_grad_(x_grad), w.detach().requires_grad_(True),
                      b.detach().requires_grad_(True)]
            y = fn(*leaves)
            y.backward(gy)
            return [y.detach()] + [t.grad for t in leaves if t.grad is not None]

        fn_kernel = lambda xx, ww, bb, s=s, plain=plain: conv_block(xx, ww, bb, s, plain)
        fn_plain = lambda xx, ww, bb, s=s, plain=plain: plain(xx, ww, bb, s)
        pad = (s.pw, s.kw - 1 - s.pw, s.ph, s.kh - 1 - s.ph)

        def fn_library(xx, ww, bb, s=s, pad=pad):
            x4 = xx.reshape(nb, s.H, s.W, s.Ci).permute(0, 3, 1, 2)
            y = F.relu(F.conv2d(F.pad(x4, pad), ww.permute(3, 2, 0, 1), bb))
            y = F.max_pool2d(y, 2) if s.pool else y
            return y.permute(0, 2, 3, 1).reshape(nb, s.Ho, s.Wo * s.Co)

        got, ref = run(fn_kernel), run(fn_plain)
        torch.cuda.synchronize()
        errs = [float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)]
        scales = [float(r.float().abs().max()) for r in ref]
        names = ["y"] + (["dx"] if x_grad else []) + ["dw", "db"]
        ok = all(e <= REL_TOL * max(sc, 1e-6) for e, sc in zip(errs, scales))
        note = ""
        if not ok:
            # [bwd]'s rule: the route may gate a few elements otherwise than
            # the plain block where the two f32 sums round z to either side
            # of a relu or pool decision, which moves a whole cotangent. Then
            # every such element must be a rounding flip, at most
            # DZ_MISMATCH of dz, and each gradient the plain pieces on the
            # kernel's own routing, within REL_TOL
            dz, dbpart = conv_block_route(x, w, b, gy, s, plain)
            dz_ref, _ = route_plain(x, w, b, gy, s, plain)
            flips, explained = rounding_flips(x, w, b, s, dz, dz_ref, plain)
            on_dz = ([dgrad_plain(dz, w, s)] if x_grad else []) + list(
                wgrad_plain(x, dz, dbpart, s))
            routed = [_rel(a, r) for a, r in zip(got[1:], on_dz)]
            ok = (errs[0] <= REL_TOL * max(scales[0], 1e-6) and explained
                  and flips <= DZ_MISMATCH * dz.numel() and all(r < REL_TOL for r in routed))
            note = (f" ({flips} dz elements routed otherwise, "
                    f"{'each a rounding flip' if explained else 'NOT at rounding'}; on the "
                    f"kernel's dz: " + " ".join(f"{n} rel {r:.3e}" for n, r in zip(names[1:], routed))
                    + ")")
            del dz, dz_ref, dbpart, on_dz
        log(f"[vjp] block{i} ({plain.__name__} rules) B={nb}: "
            + " ".join(f"{n} max|d|={e:.4g} (max|ref| {sc:.4g})" for n, e, sc in zip(names, errs, scales))
            + note + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"conv_block VJP disagrees with its plain block on block{i}")
        # bf16 bytes: x, w, b and the cotangent read once; y, dw, db (and
        # dx where x takes a gradient) written once. Operations: the
        # forward conv, the weight gradient, and the input gradient where
        # it is computed
        n_bytes = 2 * (x.numel() + w.numel() + b.numel() + gy.numel()
                       + gy.numel() + w.numel() + b.numel() + x.numel() * x_grad)
        n_ops = (2 + x_grad) * nb * needed_flops(s)
        row = {
            "block": f"block{i}",
            "rules": plain.__name__,
            "shape": [nb, s.H, s.W, s.Ci, s.Co, s.kh, int(s.pool)],
            "max_abs_err": max(errs),
            "max_abs_err_by_output": dict(zip(names, errs)),
            "ms": time_ms(lambda: run(fn_kernel), iters=5, warmup=2),
            **bound(n_bytes, n_ops),
        }
        if not detail:
            log(f"[vjp] block{i} ({rules}): fwd+bwd kernel path {row['ms']:.3f} ms")
            rows.append(row)
            x = ref[0]
            continue
        row["plain_ms"] = time_ms(lambda: run(fn_plain), iters=5, warmup=2)
        row["library_ms"] = time_ms(lambda: run(fn_library), iters=5, warmup=2)
        log(f"[vjp] block{i}: fwd+bwd kernel path {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

        # each backward kernel alone, on this block's inputs; "ms" is CUDA
        # events around the wrapper (host issue included where the host is
        # slower than the card), "device_ms" the profiler's kernel time
        dz, dbpart, calls = bwd_calls(x, w, b, gy, s, plain, x_grad)
        dev_t = device_times(calls)
        n_x, n_dz = x.numel() * x.element_size(), dz.numel() * 2
        ops = nb * needed_flops(s)
        plains = {"route": lambda: route_plain(x, w, b, gy, s, plain),
                  "wgrad": lambda: wgrad_plain(x, dz, dbpart, s),
                  "dgrad": lambda: dgrad_plain(dz, w, s)}
        n_bytes = {"route": route_bound(x, w, b, gy, s, nb)["bytes"],
                   "wgrad": n_x + n_dz + 2 * (w.numel() + b.numel()),
                   "dgrad": n_dz + 2 * w.numel() + n_x}
        kern = {}
        for k in [k for k in ("route", "dgrad", "wgrad") if k in calls]:
            lib = calls.get(f"library {k}")
            kern[k] = {
                "ms": time_ms(calls[k], iters=5, warmup=2),
                "device_ms": dev_t[k]["device_ms"],
                "device_by_kernel": dev_t[k]["by_kernel"],
                "plain_ms": time_ms(plains[k], iters=5, warmup=2),
                "library_ms": None if lib is None else time_ms(lib, iters=5, warmup=2),
                "library_device_ms": None if lib is None else dev_t[f"library {k}"]["device_ms"],
                "library_device_by_kernel": (None if lib is None
                                             else dev_t[f"library {k}"]["by_kernel"]),
                **bound(n_bytes[k], ops),
            }
        row["bwd_kernels"] = kern

        def lib_text(v):
            if v["library_ms"] is None:
                return "library -"
            return (f"library {v['library_ms']:.4f}, device {_ms(v['library_device_ms'])}: "
                    + ", ".join(f"{n} {t:.4f}" for n, t in v["library_device_by_kernel"].items()))

        def share(v):
            if v["device_ms"] is None:
                return "device time not measured"
            return f"{100 * v['bound_ms'] / v['device_ms']:.1f}% of it on device time"

        log(f"[vjp] block{i} backward kernels at B={nb}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms, device {_ms(v['device_ms'])} ("
            + ", ".join(f"{n} {t:.4f}" for n, t in v["device_by_kernel"].items())
            + f"; plain {v['plain_ms']:.4f}, {lib_text(v)}, bound "
            f"{v['bound_ms']:.4f} {v['bound_by']}, {share(v)})" for k, v in kern.items()))
        rows.append(row)
        del dz, dbpart, calls
        x = ref[0]  # the next block takes this block's output
    set_launch_counts(saved)  # comparison launches do not count
    return rows


def summed_bound(parts) -> dict:
    """:func:`bound` of the summed bytes and operations of ``parts``."""
    out = bound(sum(p["bytes"] for p in parts), sum(p["ops"] for p in parts))
    return {"bound_ms": out["bound_ms"], "bound_by": out["bound_by"]}


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time of the work on an H100 SXM at 700 W: bytes over the
    memory rate or operations over the dense bf16 rate, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _rel_l2(got, ref):
    """Per-parameter ||got - ref|| / max(||ref||, 1e-3 ||all ref||)."""
    total = math.sqrt(sum(float(r.double().square().sum()) for r in ref.values()))
    return {k: float((got[k].double() - ref[k].double()).norm())
            / max(float(ref[k].double().norm()), 1e-3 * total) for k in ref}


def grads_kernels_vs_plain(dev, grads_of, what: str, num_actions: int = 6) -> dict:
    """``grads_of(net) -> (gradients in parameter order, loss)`` through
    BA3CNet(num_actions) at full width with conv_backend="cuda" (the kernel forward
    and the backward kernels) and "torch" (the plain blocks under
    autograd), under the default block_rules ("xla", the trainer's): the
    per-parameter rel-L2 of the two, and each one's peak device memory
    (``max_memory_allocated`` over the call, what earlier phases left
    allocated included) and its peak above what was allocated before the
    call (the call's own)."""
    import torch

    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    grads, aux, peak, own = {}, {}, {}, {}
    for backend in ("cuda", "torch"):
        net = BA3CNet(num_actions, conv_backend=backend, device=dev,
                      generator=torch.Generator().manual_seed(0))
        rules = net.block_rules  # the trainer's: every entry point's default
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        gs, loss = grads_of(net)
        torch.cuda.synchronize()
        peak[backend] = torch.cuda.max_memory_allocated(dev)
        own[backend] = peak[backend] - before
        grads[backend] = {k: gr for (k, _), gr in zip(net.named_parameters(), gs)}
        aux[backend] = float(loss.detach())
        del net, gs, loss
    errs = _rel_l2(grads["cuda"], grads["torch"])
    worst = max(errs, key=errs.get)
    log(f"{what} gradients (block_rules={rules}), kernels vs plain blocks: "
        f"worst rel-L2 {errs[worst]:.3e} ({worst}); loss {aux['cuda']:.6f} vs {aux['torch']:.6f}; "
        f"peak memory {peak['cuda'] / 2**30:.3f} GiB vs {peak['torch'] / 2**30:.3f} GiB "
        f"({own['cuda'] / 2**30:.3f} vs {own['torch'] / 2**30:.3f} GiB above the call's start)")
    if not all(torch.isfinite(v).all() for v in grads["cuda"].values()):
        raise AssertionError(f"{what}: gradients on the card are not finite")
    if errs[worst] >= GRAD_REL_L2:
        raise AssertionError(f"{what}: gradients disagree: {errs}")
    return {"rel_l2": errs, "peak_bytes": peak, "call_peak_bytes": own}


def phase_train_grads(dev, states, num_actions: int = 6, tag: str = "[train]"):
    """One learner chunk (B = len(states) game states: 2560 of Pong, the
    fused trainer's; 128, the sync trainer's; 4096 of CoinRun, a chunk of
    BASELINE config #5) through the a3c loss's gradients, kernels against
    plain blocks (:func:`grads_kernels_vs_plain`)."""
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.parallel.train_step import learner_grads

    n = states.shape[0]
    g = torch.Generator(device=dev).manual_seed(2)
    actions = torch.randint(0, num_actions, (n,), generator=g, device=dev)
    returns = torch.randn((n,), generator=g, device=dev)

    def grads_of(net):
        gs, loss = learner_grads(net, BA3CConfig(num_actions=num_actions), states, actions,
                                 returns, 0.01, grad_chunk_samples=n)
        return gs, loss.total

    return grads_kernels_vs_plain(dev, grads_of, f"{tag} learner chunk B={n}", num_actions)


def phase_train_cli(dev):
    """The trainer through its entry point: 128 envs x 20 steps per update,
    5 updates x 2 epochs, a 200-step greedy eval of 8 envs per epoch."""
    import tempfile

    from distributed_ba3c_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        rc = cli_main(["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "jax:pong",
                       "--batch_size", str(TRAIN_B), "--rollout_len", str(TRAIN_T),
                       "--steps_per_epoch", "5", "--max_epoch", "2", "--nr_eval", "8",
                       "--eval_max_steps", "200", "--logdir", logdir,
                       "--device", str(dev)])
        wall = time.perf_counter() - t0
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
    if rc != 0:
        raise AssertionError(f"--task train returned {rc}")
    for rec in stats:
        for k in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"epoch {rec['epoch']}: {k} = {rec[k]}")
    log(f"[train] cli: {len(stats)} epochs in {wall:.2f} s; " + "; ".join(
        f"epoch {int(r['epoch'])}: env-steps/s {r['fps']:.1f} loss {r['loss']:.5f} "
        f"entropy {r['entropy']:.4f} grad_norm {r['grad_norm']:.4f}" for r in stats))
    return {"wall_s": wall, "updates": 10, "evals": 2, "eval_steps": 200, "epochs": stats}


def phase_train_step(dev, game: str = "pong", n_envs: int = TRAIN_ENVS, T: int = TRAIN_T,
                     chunk: int = 4096, tag: str = "[train]"):
    """The fused step at a trainer's shape (``n_envs`` envs of ``game`` x
    ``T`` steps, learner chunks of ``chunk`` samples) through the API: launches
    per update, a step at learning rate 0 leaves the params equal, a live
    step moves them; and the update's parts timed with CUDA events."""
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.envs import jaxenv
    from distributed_ba3c_tpu_torch.fused.loop import (
        push_frame,
        create_fused_state,
        make_fused_step,
    )
    from distributed_ba3c_tpu_torch.parallel.train_step import learner_grads
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    env = jaxenv.get_env(game)
    samples = n_envs * T
    cfg = BA3CConfig(batch_size=samples, num_actions=env.num_actions)
    net = BA3CNet(env.num_actions, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_fused_state(0, net, cfg, env, n_envs)
    opt = state.train.optimizer
    step = make_fused_step(net, opt, cfg, env, T, grad_chunk_samples=chunk)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    before_launches = launch_counts()
    state, m = step(state, 0.01, 0.0)
    torch.cuda.synchronize()
    per_update = {k: v - before_launches[k] for k, v in launch_counts().items()}
    same = all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    state, m = step(state, 0.01, 1e-3)
    torch.cuda.synchronize()
    moved = sum(not torch.equal(v, before[k]) for k, v in net.state_dict().items())
    finite = all(math.isfinite(float(v)) for v in m.values())
    log(f"{tag} step API: launches per update {per_update}; lr=0 leaves params equal: {same}; "
        f"lr=1e-3 moved {moved}/{len(before)} tensors; metrics finite: {finite}")
    if not (same and moved > 0 and finite):
        raise AssertionError(f"{tag} the fused step's update is wrong")

    # the parts of one update at its shapes
    B = n_envs
    stack = state.obs_stack
    actions = torch.randint(0, env.num_actions, (B,), device=dev, dtype=torch.int32)

    def env_step():
        st, obs, _, done = env.step(state.env_state, actions, state.draws.env_noise(B, dev))
        return push_frame(stack, obs, done)

    flat_states = torch.cat([stack] * T)
    flat_actions = torch.randint(0, env.num_actions, (samples,), device=dev)
    flat_returns = torch.randn((samples,), device=dev)
    grads, _ = learner_grads(net, cfg, flat_states, flat_actions, flat_returns, 0.01, chunk)
    opt.set_learning_rate(0.0)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: net(stack), iters=10)
    parts = {
        "rollout_forward_ms": T * fwd_ms,
        "bootstrap_forward_ms": fwd_ms,
        "env_step_ms": T * time_ms(env_step, iters=10),
        "learner_fwd_bwd_ms": time_ms(
            lambda: learner_grads(net, cfg, flat_states, flat_actions, flat_returns, 0.01, chunk),
            iters=3, warmup=1),
        "optimizer_ms": time_ms(lambda: opt.step(grads), iters=10),
    }
    saved = launch_counts()
    parts["update_ms"] = time_ms(lambda: step(state, 0.01, 0.0), iters=3, warmup=1)
    set_launch_counts(saved)
    parts["parts_sum_ms"] = sum(v for k, v in parts.items() if k not in ("update_ms",))
    parts["env_steps_per_s"] = samples / parts["update_ms"] * 1e3
    log(f"{tag} per update (B={B} envs x T={T}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    return {"launches_per_update": per_update, **parts}


#: the packages the sync trainer's actor plane and the telemetry would need
#: (module, distribution): probed, never installed
PROBED = (("zmq", "pyzmq"), ("msgpack", "msgpack"), ("tensorboard", "tensorboard"),
          ("gymnasium", "gymnasium"))


def phase_env_probe(card: str) -> dict:
    """Which of PROBED this machine has, with their versions, and the card
    as nvidia-smi names it. Informational: it never fails the run."""
    import importlib.metadata
    import importlib.util

    found = {}
    for module, dist in PROBED:
        try:
            if importlib.util.find_spec(module) is None:
                found[module] = "missing"
            else:
                found[module] = importlib.metadata.version(dist)
        except Exception as e:  # a broken install is reported, not fatal
            found[module] = f"unreadable ({type(e).__name__})"
    log("[env] " + " ".join(f"{k} {v}" for k, v in found.items()) + f"; {card}")
    return found


def phase_resume(dev, states):
    """A run kept and resumed through the CLI at full width (jax:pong, 128
    envs x 20 steps, 2 updates an epoch, an 8-env greedy eval of 200
    steps): one epoch; a resume under ``hyper.txt``'s learning rate 0 that
    continues at epoch 2 and leaves the params bit-equal; a resume with the
    budget spent that adds no epoch; ``--task eval|play --load``, which
    must serve the params read from the checkpoint's file directly; the
    checkpoint's greedy actions on Pong states against a plain BA3CNet with
    those params; a save -> restore round trip on the card.
    Returns the phase's numbers and the launches of each part."""
    import logging
    import tempfile

    import numpy as np
    import torch

    from distributed_ba3c_tpu_torch.cli import main as cli_main
    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
    from distributed_ba3c_tpu_torch.models.convert import from_flax
    from distributed_ba3c_tpu_torch.predict import server
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor
    from distributed_ba3c_tpu_torch.train.checkpoint import (
        CheckpointManager,
        restore_params,
        restore_train_state,
        train_state_payload,
    )

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as logdir:
        ckdir = os.path.join(logdir, "checkpoints")
        train = ["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "jax:pong",
                 "--batch_size", str(TRAIN_B), "--rollout_len", str(TRAIN_T),
                 "--steps_per_epoch", "2", "--nr_eval", "8", "--eval_max_steps", "200",
                 "--logdir", logdir, "--device", str(dev)]

        def cli(argv, name):
            lines, logger = Lines(), logging.getLogger("ba3c")
            level = logger.level
            logger.addHandler(lines)
            logger.setLevel(logging.INFO)
            try:
                rc = cli_main(argv)
            finally:
                logger.removeHandler(lines)
                logger.setLevel(level)
            if rc != 0:
                raise AssertionError(f"[resume] {name} returned {rc}")
            return lines.lines

        def meta():
            with open(os.path.join(ckdir, "checkpoint.json")) as f:
                return json.load(f)

        def stats():
            with open(os.path.join(logdir, "stat.json")) as f:
                return json.load(f)

        set_launch_counts({k: 0 for k in COUNTED})
        cli(train + ["--max_epoch", "1"], "run 1")
        checks = {"run 1: latest 2": meta()["latest"] == 2}
        with open(os.path.join(logdir, "hyper.txt"), "w") as f:
            f.write("learning_rate: 0\n")
        lines = cli(train + ["--max_epoch", "2", "--load", ckdir], "run 2 (resume)")
        checks["run 2: continuing at epoch 2"] = any("continuing at epoch 2" in m for m in lines)
        st = stats()
        checks["run 2: epochs [1, 2], steps [2, 4]"] = (
            [int(r["epoch"]) for r in st] == [1, 2] and [int(r["global_step"]) for r in st] == [2, 4])
        mgr = CheckpointManager(ckdir)
        p2, p4 = mgr.restore(2), mgr.restore(4)
        checks["run 2: params at step 4 bit-equal to step 2 (lr 0)"] = all(
            torch.equal(p4["params"][k][n], t) for k, v in p2["params"].items() for n, t in v.items())
        checks["run 2: Adam count 4"] = int(p4["opt"]["count"]) == 4
        lines = cli(train + ["--max_epoch", "2", "--load", ckdir], "run 3 (spent budget)")
        checks["run 3: no epoch added"] = (len(stats()) == 2 and meta()["latest"] == 4
                                           and any("nothing to train" in m for m in lines))
        launches["train"] = launch_counts()

        # the params of step 4 read from its file directly, not through the
        # checkpoint module: what eval, play and the served net must hold
        direct = from_flax(torch.load(os.path.join(ckdir, "ckpt-4", "state.pt"),
                                      map_location="cpu", weights_only=True)["params"])
        served_params = []

        def spy(model, params, **kw):
            served_params.append({k: v.detach().cpu().clone() for k, v in params.items()})
            return real_predictor(model, params, **kw)

        real_predictor = server.BatchedPredictor
        server.BatchedPredictor = spy
        try:
            for task, n, steps in (("eval", "2", "300"), ("play", "1", "100")):
                set_launch_counts({k: 0 for k in COUNTED})
                cli(["--task", task, "--env", "cpp:pong", "--nr_eval", n, "--max_steps", steps,
                     "--load", ckdir, "--device", str(dev)], f"{task} --load")
                launches[task] = launch_counts()
        finally:
            server.BatchedPredictor = real_predictor
        checks["eval and play --load serve the params of step 4"] = len(served_params) == 2 and all(
            p.keys() == direct.keys() and all(torch.equal(p[k], v) for k, v in direct.items())
            for p in served_params)

        # the checkpoint's greedy actions, served, against a plain BA3CNet
        # whose params are loaded directly
        x = torch.from_numpy(states[0]).to(dev)
        served_net = BA3CNet(6, device=dev)
        step = restore_params(served_net, ckdir)
        pred = BatchedPredictor(served_net, served_net.state_dict(), batch_size=x.shape[0],
                                greedy=True, device=dev)
        served, _, _ = pred.predict_batch(states[0])
        plain = BA3CNet(6, conv_backend="torch", device=dev,
                        generator=torch.Generator().manual_seed(1))
        plain.load_state_dict(direct)
        with torch.inference_mode():
            logits = plain(x).logits
        band = REL_TOL * float(logits.abs().max())
        top2 = torch.topk(logits, 2, dim=-1).values
        clear = ((top2[:, 0] - top2[:, 1]) > band).cpu().numpy()
        same = np.asarray(served) == logits.argmax(-1).cpu().numpy()
        checks["served actions of step 4 = argmax of the loaded plain net"] = (
            step == 4 and bool(same[clear].all()))
        log(f"[resume] greedy actions from the checkpoint equal on {int(same[clear].sum())}/"
            f"{int(clear.sum())} rows with margin > {band:.3g}")

        # save -> restore on the card, bit-equal params and Adam state
        def fresh(seed):
            net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(seed))
            return create_train_state(net, BA3CConfig())

        a = restore_train_state(fresh(2), mgr, 4)
        rt = CheckpointManager(os.path.join(logdir, "round_trip"))
        rt.save(train_state_payload(a), a.step)
        b = restore_train_state(fresh(3), rt)
        sa, sb = a.optimizer.adam.state, b.optimizer.adam.state
        checks["round trip on the card bit-equal"] = (
            a.step == b.step == 4
            and all(p.device == dev for p in b.model.parameters())
            and all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
            and all(torch.equal(sa[pa][f], sb[pb][f]) for pa, pb in
                    zip(a.optimizer.params, b.optimizer.params) for f in ("exp_avg", "exp_avg_sq", "step"))
            and all(sb[pb]["exp_avg"].device == dev for pb in b.optimizer.params))
    wall = time.perf_counter() - t0
    for k, ok in checks.items():
        log(f"[resume] {k}: {'ok' if ok else 'FAIL'}")
    log(f"[resume] launches {launches}; phase {wall:.2f} s")
    if not all(checks.values()):
        raise AssertionError("[resume] " + ", ".join(k for k, v in checks.items() if not v))
    return {"wall_s": wall, "launches": launches, "checks": checks}


SYNC_B = 128          # the sync learner's batch (the config's batch_size)
SYNC_STEPS = 100      # learner steps per epoch of the [sync] runs
SYNC_SIMS = 64        # envs of the cpp:pong fleet: 4 env servers x 16
SYNC_BUCKETS = 5      # warmup(): the pow-2 buckets 1..16 of predict_batch_size 16
SYNC_SERVE_B = 16     # a served batch: one env server's block (predict_batch_size)


def _tele(role: str) -> dict:
    from distributed_ba3c_tpu_torch import telemetry

    return telemetry.registry(role).scalars()


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def _hist_p99_us(role: str, name: str) -> float:
    """The upper edge, in us, of the log2 bucket holding the 99th
    percentile of a histogram (its resolution is a factor of two)."""
    from distributed_ba3c_tpu_torch import telemetry

    h = telemetry.registry(role).histogram(name)
    counts, total, seen = h.buckets(), h.count, 0
    for i, c in enumerate(counts):
        seen += c
        if total and seen >= 0.99 * total:
            return h.unit * 2 ** i * 1e6
    return float("nan")


def _sync_run(argv, dev, tag: str = "[sync]"):
    """One CLI run of a ZMQ trainer (``tpu_sync_ba3c``, ``tpu_vtrace_ba3c``):
    its wall time, its launches and the telemetry deltas of every role it
    feeds. The histograms it reads (step_s, feed_wait_s, serve_latency_s)
    are reset first."""
    from distributed_ba3c_tpu_torch import telemetry
    from distributed_ba3c_tpu_torch.cli import main as cli_main

    for role, name in (("learner", "step_s"), ("learner", "feed_wait_s"),
                       ("predictor", "serve_latency_s")):
        telemetry.registry(role).histogram(name).reset()
    roles = ("learner", "predictor", "master", "fleet")
    before = {r: _tele(r) for r in roles}
    set_launch_counts({k: 0 for k in COUNTED})
    t0 = time.perf_counter()
    rc = cli_main([*argv, "--device", str(dev)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag} {argv} returned {rc}")
    out = {"wall_s": wall, "launches": launch_counts(),
           **{r: _delta(_tele(r), before[r]) for r in roles}}
    out["serve_p99_us"] = _hist_p99_us("predictor", "serve_latency_s")
    # the counters as the last epoch's stat.json record holds them: before
    # the teardown, where stopping the predictor sheds what is still queued
    with open(os.path.join(argv[argv.index("--logdir") + 1], "stat.json")) as f:
        last = json.load(f)[-1]
    out["at_last_epoch"] = {
        r: {k: last[f"tele/{r}/{k}"] - before[r].get(k, 0.0)
            for k in _tele(r) if f"tele/{r}/{k}" in last}
        for r in roles}
    return out


def _sync_checks(run, steps: int, exact_serving: bool, tag: str = "[sync]",
                 samples_per_step: int = SYNC_B):
    """The invariants of one ZMQ-trainer run (see phase_sync)."""
    L, P, M = run["launches"], run["predictor"], run["master"]
    batches = int(P["batches_total"])
    want = {"conv_block_vjp": 4 * steps, "conv_block_route": 4 * steps,
            "conv_block_dgrad": 3 * steps, "conv_block_wgrad": 4 * steps}
    got = {k: L[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag} backward launches {got}, expected {want} (4/4/3/4 a step)")
    serve_fwd = L["conv_block_fwd"] - 4 * steps
    if exact_serving and serve_fwd != 4 * (batches + SYNC_BUCKETS):
        raise AssertionError(
            f"{tag} {L['conv_block_fwd']} forward launches: not 4 a learner step ({steps}) "
            f"+ 4 a served batch ({batches}) + 4 a warmup bucket ({SYNC_BUCKETS})")
    if serve_fwd < 4 * batches:
        raise AssertionError(f"{tag} {serve_fwd} serving forwards for {batches} batches")
    if P["param_publishes_total"] < steps:  # --publish_every 1
        raise AssertionError(f"{tag} {P['param_publishes_total']} publishes for {steps} steps")
    if M["datapoints_total"] < steps * samples_per_step:
        raise AssertionError(f"{tag} {M['datapoints_total']} datapoints for {steps} steps")
    for k in ("corrupt_frames_total", "clients_dropped_total", "blocks_rejected_total"):
        if M.get(k, 0):
            raise AssertionError(f"{tag} master {k} = {M[k]}")
    # a shed row is answered with a uniform-random action, and a callback
    # that raised is logged and skipped: either would let a broken plane
    # pass. Read up to the last epoch's end: the teardown sheds by design
    end = run["at_last_epoch"]
    for role, k in (("master", "predictor_shed_fallbacks_total"),
                    ("predictor", "sheds_total"), ("predictor", "callback_errors_total")):
        if k not in end[role]:
            raise AssertionError(f"{tag} stat.json holds no tele/{role}/{k}")
        if end[role][k]:
            raise AssertionError(f"{tag} {role} {k} = {end[role][k]} by the last epoch's end")
    if P.get("callback_errors_total", 0):
        raise AssertionError(f"{tag} predictor callback_errors_total = {P['callback_errors_total']}")


def _sync_numbers(run, steps: int) -> dict:
    """The card's numbers of one run, from its telemetry."""
    Lr, P, F, M = run["learner"], run["predictor"], run["fleet"], run["master"]
    wall = run["wall_s"]
    step_s = Lr["step_s_sum"] / max(Lr["step_s_count"], 1)
    return {
        "steps": steps,
        "wall_s": wall,
        "learner_step_host_ms": 1e3 * step_s,
        "feed_wait_share": Lr["feed_wait_s_sum"] / max(Lr["step_s_sum"], 1e-12),
        "predictor_rows_per_s": P["rows_total"] / wall,
        "rows_per_batch": P["rows_total"] / max(P["batches_total"], 1),
        "serve_mean_ms": 1e3 * P["serve_latency_s_sum"] / max(P["serve_latency_s_count"], 1),
        "serve_p99_ms_upper": run["serve_p99_us"] / 1e3,
        "fleet_env_steps_per_s": F.get("env_steps_total", 0.0) / wall,
        "datapoints_per_s": M["datapoints_total"] / wall,
        "blocked_puts": M.get("queue_blocked_puts_total", 0.0),
    }


def phase_sync(dev, states):
    """The sync trainer through its entry point at full width:
    ``--trainer tpu_sync_ba3c --env cpp:pong --wire block-shm
    --simulator_procs 64 --batch_size 128`` (4 native env servers of 16
    envs, BA3CNet(6), fc 512) for 2 epochs of SYNC_STEPS steps, then a
    ``--load`` resume for one more epoch in the same logdir; then a short
    ``--env fake --wire per-env`` run of 8 python simulators with the
    greedy Evaluator. Each run: 4 forward, 4 route, 3 dgrad and 4 wgrad
    launches a learner step, 4 forwards a served batch (exactly, on the
    eval-free runs), block-shm messages and no corrupt frame or dropped
    client, no shed row and no failed callback up to the last epoch's end,
    a publish a step, SYNC_B datapoints a step. Then a B=128 learner
    batch's gradients, kernels against plain blocks, the kernels timed at
    the path's batches (B=16 served, B=128 learned), and the learner step
    timed on the card."""
    import tempfile

    import numpy as np
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )

    base = ["--task", "train", "--trainer", "tpu_sync_ba3c", "--batch_size", str(SYNC_B),
            "--steps_per_epoch", str(SYNC_STEPS), "--nr_eval", "0"]
    pong = ["--env", "cpp:pong", "--wire", "block-shm", "--simulator_procs", str(SYNC_SIMS)]
    with tempfile.TemporaryDirectory() as logdir:
        first = _sync_run([*base, *pong, "--max_epoch", "2", "--logdir", logdir], dev)
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
        resumed = _sync_run([*base, *pong, "--max_epoch", "1", "--logdir", logdir,
                             "--load", os.path.join(logdir, "checkpoints")], dev)
        with open(os.path.join(logdir, "stat.json")) as f:
            all_stats = json.load(f)
        with open(os.path.join(logdir, "checkpoints", "checkpoint.json")) as f:
            ckpt = json.load(f)
    steps = [r["global_step"] for r in all_stats]
    log(f"[sync] cpp:pong block-shm: global_step per epoch {steps}; checkpoint latest "
        f"{ckpt['latest']}")
    if steps != [SYNC_STEPS, 2 * SYNC_STEPS, 3 * SYNC_STEPS] or ckpt["latest"] != 3 * SYNC_STEPS:
        raise AssertionError("[sync] the --load run did not continue at the saved step")
    for rec in all_stats:
        for k in ("loss", "entropy", "grad_norm"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"[sync] epoch {rec['epoch']}: {k} = {rec[k]}")
    for run in (first, resumed):
        if run["master"]["block_shm_msgs_total"] <= 0:
            raise AssertionError("[sync] no block-shm message reached the master")
    _sync_checks(first, 2 * SYNC_STEPS, exact_serving=True)
    _sync_checks(resumed, SYNC_STEPS, exact_serving=True)

    with tempfile.TemporaryDirectory() as logdir:
        fake = _sync_run([*base[:-2], "--env", "fake", "--wire", "per-env",
                          "--simulator_procs", "8", "--steps_per_epoch", "20",
                          "--max_epoch", "1", "--nr_eval", "4", "--logdir", logdir], dev)
        with open(os.path.join(logdir, "stat.json")) as f:
            fake_stats = json.load(f)
    if fake["master"]["per_env_msgs_total"] <= 0 or "eval_mean_score" not in fake_stats[-1]:
        raise AssertionError("[sync] fake/per-env run: no per-env message or no eval")
    _sync_checks(fake, 20, exact_serving=False)

    numbers = {"first": _sync_numbers(first, 2 * SYNC_STEPS),
               "resumed": _sync_numbers(resumed, SYNC_STEPS),
               "fake_per_env": _sync_numbers(fake, 20)}
    numbers["fps"] = [r["fps"] for r in all_stats]
    numbers["train_queue_depth"] = [r.get("tele/master/train_queue_depth") for r in all_stats]
    for name, n in numbers.items():
        if isinstance(n, dict):
            log(f"[sync] {name}: " + ", ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in n.items()))
    log(f"[sync] stat.json fps {numbers['fps']}; train_queue_depth at epoch ends "
        f"{numbers['train_queue_depth']}; fake eval_mean_score "
        f"{fake_stats[-1]['eval_mean_score']:.3f}")

    # a B=128 learner batch: kernels against plain blocks, and its time
    x = torch.from_numpy(np.concatenate(states)[:SYNC_B]).to(dev)
    grad = phase_train_grads(dev, x)
    # the kernels at this path's own batches: the learner's forward and
    # backward of the four blocks at B=128, a served batch's forward (the
    # model path's blocks) at B=16 and B=128
    saved = launch_counts()
    vjp = phase_vjp(dev, x)
    fwd_rows, _ = phase_kernels(dev, batches=(SYNC_SERVE_B, SYNC_B),
                                timed_batches=(SYNC_SERVE_B, SYNC_B))
    set_launch_counts(saved)
    kernel_ms = {f"fwd_b{nb}": sum(r["ms"] for r in rows if r["block"] != "block0_uint8")
                 for nb, rows in fwd_rows.items()}
    kernel_ms[f"fwd_bwd_b{SYNC_B}"] = sum(r["ms"] for r in vjp)
    kernel_ms[f"plain_fwd_bwd_b{SYNC_B}"] = sum(r["plain_ms"] for r in vjp)
    kernel_ms[f"library_fwd_bwd_b{SYNC_B}"] = sum(r["library_ms"] for r in vjp)
    numbers["kernel_ms"] = kernel_ms
    log("[sync] the kernels at the sync batches (CUDA events, the four blocks summed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in kernel_ms.items()))
    cfg = BA3CConfig(batch_size=SYNC_B)
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_train_state(net, cfg)
    step = make_train_step(net, state.optimizer, cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"state": x, "action": torch.randint(0, 6, (SYNC_B,), generator=g, device=dev),
             "return": torch.randn((SYNC_B,), generator=g, device=dev)}
    saved = launch_counts()
    numbers["learner_step_device_ms"] = time_ms(lambda: step(state, batch, 0.01, 0.0), iters=20)
    set_launch_counts(saved)
    log(f"[sync] learner step at B={SYNC_B} on the card (CUDA events, lr 0): "
        f"{numbers['learner_step_device_ms']:.4f} ms")
    numbers["plane_alone"] = phase_plane_alone(dev)
    return {"launches": {"train": first["launches"], "resumed": resumed["launches"],
                         "fake": fake["launches"]},
            "numbers": numbers, "grad_rel_l2_b128": grad["rel_l2"]}


def phase_plane_alone(dev, seconds: float = 5.0, trace_sample: int = 0,
                      tag: str = "[sync]") -> dict:
    """The [sync] run's actor plane without its learner: the cpp:pong fleet
    (4 block-shm env servers of 16 envs), the master and the predictor,
    the train queue drained by a thread that only counts. Its rates, set
    against the full run's, give what the learner's thread costs the plane
    (they share one interpreter). ``trace_sample`` > 0 arms the trace
    plane here and in the env servers (``BA3C_TRACE``) for this run."""
    import tempfile
    import threading

    import torch

    from distributed_ba3c_tpu_torch.telemetry import tracing

    from distributed_ba3c_tpu_torch.actors.master import BA3CSimulatorMaster
    from distributed_ba3c_tpu_torch.cli import _sync_fleet, build_config, make_parser
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor

    args = make_parser().parse_args(["--env", "cpp:pong", "--wire", "block-shm",
                                     "--simulator_procs", str(SYNC_SIMS)])
    cfg = build_config(args)
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(0))
    pred = BatchedPredictor(BA3CNet(6, device=dev), net.state_dict(),
                            batch_size=cfg.predict_batch_size, device=dev)
    pred.warmup(cfg.state_shape)
    with tempfile.TemporaryDirectory() as d:
        c2s, s2c = f"ipc://{d}/c2s", f"ipc://{d}/s2c"
        master = BA3CSimulatorMaster(c2s, s2c, pred, local_time_max=cfg.local_time_max)
        master.feed_batch = SYNC_B
        procs = _sync_fleet(args, cfg, c2s, s2c, master)
        stop, drained = threading.Event(), [0]

        def drain():
            while not stop.is_set():
                try:
                    master.queue.get(timeout=0.2)
                    drained[0] += 1
                except Exception:
                    pass

        t = threading.Thread(target=drain, daemon=True)
        pred.start()
        master.start()
        t.start()
        tracing.set_sampling(trace_sample)
        os.environ["BA3C_TRACE"] = str(trace_sample)
        try:
            for p in procs:
                p.start()
            time.sleep(2.0)  # the servers' start
            before, n0, t0 = _tele("predictor"), drained[0], time.perf_counter()
            time.sleep(seconds)
            after, n1, wall = _tele("predictor"), drained[0], time.perf_counter() - t0
        finally:
            tracing.set_sampling(0)
            os.environ.pop("BA3C_TRACE", None)
            stop.set()
            started = [p for p in procs if p.pid is not None]
            for p in started:
                p.terminate()
            for p in started:
                p.join(10)
            master.close()
            pred.stop()
            pred.join(5)
    d = _delta(after, before)
    out = {"wall_s": wall, "predictor_rows_per_s": d["rows_total"] / wall,
           "rows_per_batch": d["rows_total"] / max(d["batches_total"], 1),
           "serve_mean_ms": 1e3 * d["serve_latency_s_sum"] / max(d["serve_latency_s_count"], 1),
           "datapoints_per_s": (n1 - n0) / wall}
    log(f"{tag} actor plane alone (no learner{', --trace_sample %d' % trace_sample if trace_sample else ''}): "
        + ", ".join(f"{k} {v:.6g}" for k, v in out.items()))
    return out


VT_T = 5                         # local_time_max: a V-trace segment's steps
VT_SEGS = SYNC_B // VT_T         # n_seg = batch_size // local_time_max = 25
VT_B = VT_T * VT_SEGS + VT_SEGS  # the learner's one forward: 150 states
VT_STEPS = 100                   # learner steps per epoch of the [vtrace] runs


def vtrace_batch(dev, states, T: int, n: int, seed: int = 3) -> dict:
    """A time-major V-trace batch of ``n`` segments of ``T`` steps over
    ``states`` (``T*n + n`` frame stacks: the segments', then the
    bootstrap states), with seeded actions, rewards, dones and behaviour
    log-probs around log(1/6), so the importance weights fall both sides
    of the clip."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "state": states[: T * n].reshape(T, n, *states.shape[1:]),
        "action": torch.randint(0, 6, (T, n), generator=g, device=dev, dtype=torch.int32),
        "reward": torch.randint(-1, 2, (T, n), generator=g, device=dev).float(),
        "done": (torch.rand((T, n), generator=g, device=dev) < 0.05).float(),
        "behavior_log_probs": math.log(1 / 6) + 0.05 * torch.randn(
            (T, n), generator=g, device=dev),
        "bootstrap_state": states[T * n: T * n + n],
    }


def phase_vtrace(dev, states, sync_numbers: dict):
    """The V-trace trainer through its entry point at full width:
    ``--trainer tpu_vtrace_ba3c --env cpp:pong --wire block-shm
    --simulator_procs 64`` (4 native env servers of 16 envs; the master
    emits 5-step segments with the served log-probs; 25 segments a learner
    step, one forward over 150 states) for 2 epochs of VT_STEPS steps, then
    a ``--load`` resume of one epoch. Each run: 4 forward, 4 route, 3 dgrad
    and 4 wgrad launches a learner step, 4 forwards a served batch,
    125 datapoints a step, block-shm messages, no corrupt frame, rejected
    block, dropped client, shed row or failed callback (``_sync_checks``);
    ``mean_rho`` in (0, 1]. Then a B=150 learner batch's gradients,
    kernels against plain blocks, the kernels timed at B=150 and the
    V-trace step timed on the card; the numbers beside ``[sync]``'s."""
    import tempfile

    import numpy as np
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
    from distributed_ba3c_tpu_torch.parallel.vtrace_step import (
        _make_vtrace_loss_fn,
        make_vtrace_train_step,
    )

    tag = "[vtrace]"
    spb = VT_SEGS * VT_T
    base = ["--task", "train", "--trainer", "tpu_vtrace_ba3c", "--batch_size", str(SYNC_B),
            "--local_time_max", str(VT_T), "--steps_per_epoch", str(VT_STEPS),
            "--nr_eval", "0", "--env", "cpp:pong", "--wire", "block-shm",
            "--simulator_procs", str(SYNC_SIMS)]
    with tempfile.TemporaryDirectory() as logdir:
        first = _sync_run([*base, "--max_epoch", "2", "--logdir", logdir], dev, tag)
        resumed = _sync_run([*base, "--max_epoch", "1", "--logdir", logdir,
                             "--load", os.path.join(logdir, "checkpoints")], dev, tag)
        with open(os.path.join(logdir, "stat.json")) as f:
            all_stats = json.load(f)
    steps = [r["global_step"] for r in all_stats]
    log(f"{tag} cpp:pong block-shm: global_step per epoch {steps}")
    if steps != [VT_STEPS, 2 * VT_STEPS, 3 * VT_STEPS]:
        raise AssertionError(f"{tag} the --load run did not continue at the saved step")
    for rec in all_stats:
        for k in ("loss", "entropy", "grad_norm", "mean_rho"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{tag} epoch {rec['epoch']}: {k} = {rec[k]}")
        if not 0.0 < rec["mean_rho"] <= 1.0:
            raise AssertionError(f"{tag} epoch {rec['epoch']}: mean_rho {rec['mean_rho']}")
    for run, n in ((first, 2 * VT_STEPS), (resumed, VT_STEPS)):
        if run["master"]["block_shm_msgs_total"] <= 0:
            raise AssertionError(f"{tag} no block-shm message reached the master")
        _sync_checks(run, n, exact_serving=True, tag=tag, samples_per_step=spb)
        if run["learner"]["train_samples_total"] != n * spb:
            raise AssertionError(f"{tag} {run['learner']['train_samples_total']} samples "
                                 f"counted for {n} steps of {spb}")
    numbers = {"first": _sync_numbers(first, 2 * VT_STEPS),
               "resumed": _sync_numbers(resumed, VT_STEPS)}
    numbers["fps"] = [r["fps"] for r in all_stats]
    numbers["mean_rho"] = [r["mean_rho"] for r in all_stats]
    numbers["train_queue_depth"] = [r.get("tele/master/train_queue_depth") for r in all_stats]
    for name in ("first", "resumed"):
        log(f"{tag} {name}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in numbers[name].items()))
    log(f"{tag} stat.json fps {numbers['fps']}, mean_rho {numbers['mean_rho']}; train queue "
        f"at epoch ends {numbers['train_queue_depth']} segments; beside [sync] in this run: "
        f"fps {sync_numbers['fps']}, host step "
        f"{sync_numbers['first']['learner_step_host_ms']:.4g} ms, feed wait "
        f"{sync_numbers['first']['feed_wait_share']:.4g}")

    # a B=150 learner batch: kernels against plain blocks, and its time
    x = torch.from_numpy(np.concatenate(states)[:VT_B]).to(dev)
    batch = vtrace_batch(dev, x, VT_T, VT_SEGS)
    cfg = BA3CConfig(batch_size=SYNC_B)

    def grads_of(net):
        total, _ = _make_vtrace_loss_fn(net, cfg, batch, 0.01)()
        return torch.autograd.grad(total, list(net.parameters())), total

    grad = grads_kernels_vs_plain(dev, grads_of, f"{tag} learner batch B={VT_B}")
    saved = launch_counts()
    vjp = phase_vjp(dev, x, detail=True)
    fwd_rows, _ = phase_kernels(dev, batches=(VT_B,), timed_batches=(VT_B,))
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_train_state(net, cfg)
    step = make_vtrace_train_step(net, state.optimizer, cfg)
    numbers["learner_step_device_ms"] = time_ms(lambda: step(state, batch, 0.01, 0.0), iters=20)
    set_launch_counts(saved)
    numbers["kernel_ms"] = {
        f"fwd_b{VT_B}": sum(r["ms"] for r in fwd_rows[VT_B] if r["block"] != "block0_uint8"),
        f"fwd_bwd_b{VT_B}": sum(r["ms"] for r in vjp)}
    log(f"{tag} the kernels at B={VT_B} (CUDA events, the four blocks summed): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in numbers["kernel_ms"].items())
        + f"; the V-trace step on the card (lr 0): {numbers['learner_step_device_ms']:.4f} ms")
    return {"launches": {"train": first["launches"], "resumed": resumed["launches"]},
            "numbers": numbers, "grad_rel_l2": grad["rel_l2"], "vjp_rows": vjp,
            "fwd_rows": fwd_rows[VT_B]}


OV_B = TRAIN_B + TRAIN_ENVS  # the overlap learner's forward: 2560 + 128 bootstrap = 2688
OV_STEPS = 5                  # updates per epoch of the [overlap] runs
#: launches per overlap update: 4 blocks x T actor forwards + 4 for the
#: learner's one forward over T*B + B states; one backward of each block
OV_PER_UPDATE = {"conv_block_fwd": 4 * (TRAIN_T + 1), "conv_block_vjp": 4,
                 "conv_block_route": 4, "conv_block_dgrad": 3, "conv_block_wgrad": 4}
OV_PRIME = {"conv_block_fwd": 4 * TRAIN_T}  # the priming window of each run


def _overlap_parts(dev, lag: int = 1, seed: int = 0):
    """The overlap step at the CLI's shape through the API (128 envs x 20,
    BA3CNet(6) at full width) and its state."""
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.envs.jaxenv import pong
    from distributed_ba3c_tpu_torch.fused.loop import create_fused_state
    from distributed_ba3c_tpu_torch.fused.overlap import make_overlap_step
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    cfg = BA3CConfig(batch_size=TRAIN_B)
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(seed))
    state = create_fused_state(seed, net, cfg, pong, TRAIN_ENVS)
    step = make_overlap_step(net, state.train.optimizer, cfg, pong, TRAIN_T, lag=lag)
    return net, step, step.put(state)


def phase_overlap(dev, train_cli: dict, train_step: dict):
    """The fused trainer's ``--overlap`` through its entry point at full
    width: ``--trainer tpu_fused_ba3c --overlap --env jax:pong`` (128 envs x
    20, the actor on its own stream beside the learner, lag 1) for 2 epochs
    of OV_STEPS updates with a 200-step greedy eval each, then a ``--load``
    resume of one epoch: per update 84 forward launches (80 actor, 4 for
    the learner's one forward over 2688 states), 4 route, 3 dgrad and 4
    wgrad, plus each run's priming window of 80 forwards; ``mean_rho`` in
    (0, 1] and a finite ``value_lag_mae``. Then lag 0 at learning rate 0
    bit-equal with the fused step over 2 windows on the card; a B=2688
    learner block's gradients, kernels against plain blocks, and its peak
    memory; the update timed beside the fused step's; and ``probe_overlap``."""
    import tempfile

    import torch

    from distributed_ba3c_tpu_torch.cli import main as cli_main
    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.envs.jaxenv import pong
    from distributed_ba3c_tpu_torch.fused.loop import create_fused_state, make_fused_step
    from distributed_ba3c_tpu_torch.fused.overlap import TrajBlock, make_block_grads
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    tag = "[overlap]"
    argv = ["--task", "train", "--trainer", "tpu_fused_ba3c", "--overlap", "--env", "jax:pong",
            "--batch_size", str(TRAIN_B), "--rollout_len", str(TRAIN_T),
            "--steps_per_epoch", str(OV_STEPS), "--nr_eval", "8", "--eval_max_steps", "200",
            "--device", str(dev)]
    runs = {}
    with tempfile.TemporaryDirectory() as logdir:
        for name, extra in (("train", ["--max_epoch", "2"]),
                            ("resumed", ["--max_epoch", "3", "--load",
                                         os.path.join(logdir, "checkpoints")])):
            set_launch_counts({k: 0 for k in COUNTED})
            t0 = time.perf_counter()
            rc = cli_main([*argv, *extra, "--logdir", logdir])
            runs[name] = {"wall_s": time.perf_counter() - t0, "launches": launch_counts()}
            if rc != 0:
                raise AssertionError(f"{tag} {name} returned {rc}")
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
    for name, updates, evals in (("train", 2 * OV_STEPS, 2), ("resumed", OV_STEPS, 1)):
        want = {k: updates * n + OV_PRIME.get(k, 0) for k, n in OV_PER_UPDATE.items()}
        want["conv_block_fwd"] += evals * 200 * 4
        if runs[name]["launches"] != want:
            raise AssertionError(f"{tag} {name} launches {runs[name]['launches']}, expected {want}")
    if [r["global_step"] for r in stats] != [OV_STEPS, 2 * OV_STEPS, 3 * OV_STEPS]:
        raise AssertionError(f"{tag} the --load run did not continue: {stats}")
    for rec in stats:
        for k in ("loss", "entropy", "grad_norm", "mean_rho", "value_lag_mae"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{tag} epoch {rec['epoch']}: {k} = {rec[k]}")
        if not 0.0 < rec["mean_rho"] <= 1.0:
            raise AssertionError(f"{tag} epoch {rec['epoch']}: mean_rho {rec['mean_rho']}")
    numbers = {
        "fps": [r["fps"] for r in stats], "mean_rho": [r["mean_rho"] for r in stats],
        "value_lag_mae": [r["value_lag_mae"] for r in stats],
        "fused_fps": [r["fps"] for r in train_cli["epochs"]],
    }
    log(f"{tag} cli: launches {runs}; stat.json env-steps/s {numbers['fps']} (the fused "
        f"trainer's in this run: {numbers['fused_fps']}); mean_rho {numbers['mean_rho']}; "
        f"value_lag_mae {numbers['value_lag_mae']}")

    # lag 0 at learning rate 0: bit-equal with the fused step on the card
    cfg = BA3CConfig(batch_size=TRAIN_B)
    fnet = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(4))
    fstate = create_fused_state(4, fnet, cfg, pong, TRAIN_ENVS)
    fstep = make_fused_step(fnet, fstate.train.optimizer, cfg, pong, TRAIN_T)
    onet, ostep, ostate = _overlap_parts(dev, lag=0, seed=4)
    saved = launch_counts()
    for _ in range(2):
        fstate, fm = fstep(fstate, 0.01, 0.0)
        ostate, om = ostep(ostate, 0.01, 0.0)
    torch.cuda.synchronize()
    same = {
        "obs_stack": torch.equal(fstate.obs_stack, ostate.actor.obs_stack),
        "env_state": all(torch.equal(a, b) for a, b in zip(fstate.env_state,
                                                           ostate.actor.env_state)),
        **{k: torch.equal(getattr(fstate, k), getattr(ostate.actor, k))
           for k in ("ep_return", "ep_count", "ep_return_sum")},
        **{f"metric {k}": torch.equal(fm[k], om[k])
           for k in ("episodes", "episode_return_sum", "reward_per_step")},
        "params frozen": all(torch.equal(a, b) for a, b in zip(fnet.parameters(),
                                                              onet.parameters())),
    }
    log(f"{tag} lag 0 at lr 0 against the fused step over 2 windows, bit-equal: {same}; "
        f"mean_rho {float(om['mean_rho']):.7f}")
    if not all(same.values()) or abs(float(om["mean_rho"]) - 1.0) > 1e-5:
        raise AssertionError(f"{tag} lag 0 is not the fused step: {same}")
    del fnet, fstate, fstep, onet, ostep, ostate

    # a B=2688 learner block: kernels against plain blocks, and its memory
    states = pong_train_states(dev, steps=TRAIN_T + 1)
    g = torch.Generator(device=dev).manual_seed(5)
    T, n = TRAIN_T, TRAIN_ENVS
    block = TrajBlock(
        states=states[: T * n].reshape(T, n, 84, 84, 4),
        actions=torch.randint(0, 6, (T, n), generator=g, device=dev, dtype=torch.int32),
        rewards=torch.randint(-1, 2, (T, n), generator=g, device=dev).float(),
        dones=(torch.rand((T, n), generator=g, device=dev) < 0.05).float(),
        behavior_log_probs=math.log(1 / 6) + 0.05 * torch.randn((T, n), generator=g, device=dev),
        behavior_values=0.1 * torch.randn((T, n), generator=g, device=dev),
        bootstrap_state=states[T * n:],
    )

    def grads_of(net):
        gs, aux = make_block_grads(net, cfg)(block, 0.01)
        return gs, aux["loss"]

    grad = grads_kernels_vs_plain(dev, grads_of, f"{tag} learner block B={OV_B}")
    flat = torch.cat([block.states.reshape(T * n, 84, 84, 4), block.bootstrap_state])
    vjp = phase_vjp(dev, flat, detail=True)
    fwd_rows, _ = phase_kernels(dev, batches=(OV_B,), timed_batches=(OV_B,))
    del states, block, flat

    # the update beside the fused step's, and the probe
    net, step, state = _overlap_parts(dev, lag=1)
    holder = [state]

    def one_update():
        holder[0], _ = step(holder[0], 0.01, 0.0)

    numbers["update_ms"] = time_ms(one_update, iters=3, warmup=1)
    numbers["fused_update_ms"] = train_step["update_ms"]
    holder[0], probe = step.probe_overlap(holder[0], 0.01, 0.0, reps=3)
    set_launch_counts(saved)
    numbers["probe"] = probe
    numbers["env_steps_per_s"] = TRAIN_B / numbers["update_ms"] * 1e3
    numbers["learner_peak_gib"] = grad["peak_bytes"]["cuda"] / 2**30
    numbers["learner_call_peak_gib"] = grad["call_peak_bytes"]["cuda"] / 2**30
    numbers["kernel_ms"] = {
        f"fwd_b{OV_B}": sum(r["ms"] for r in fwd_rows[OV_B] if r["block"] != "block0_uint8"),
        f"fwd_bwd_b{OV_B}": sum(r["ms"] for r in vjp)}
    log(f"{tag} update {numbers['update_ms']:.3f} ms ({numbers['env_steps_per_s']:.1f} "
        f"env-steps/s; the fused update in this run {numbers['fused_update_ms']:.3f} ms); "
        f"probe_overlap: " + ", ".join(f"{k} {v}" for k, v in probe.items())
        + f"; learner peak memory {numbers['learner_peak_gib']:.3f} GiB "
        f"({numbers['learner_call_peak_gib']:.3f} above the call's start); kernels "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in numbers["kernel_ms"].items()))
    return {"launches": {k: v["launches"] for k, v in runs.items()}, "numbers": numbers,
            "grad_rel_l2": grad["rel_l2"], "vjp_rows": vjp, "fwd_rows": fwd_rows[OV_B]}


#: the games of the [games] phase: card against CPU, and a fused CLI epoch
GAMES = ("breakout", "coinrun", "seaquest", "qbert", "space_invaders", "boxing", "assault")
GAME_ENVS, GAME_STEPS = 64, 100  # card against CPU: envs, steps
GAME_FLOAT_TOL = 1e-5            # float state, card against CPU
CR_ENVS, CR_T = 1024, 20         # BASELINE config #5: 1024 envs x 20 steps an update
CR_B, CR_CHUNK = CR_ENVS * CR_T, 4096  # 20480 samples an update, learner chunks of 4096
CR_UPDATES = 3                   # updates an epoch of the CoinRun runs
CR_EVAL_STEPS = 1000             # CoinRun's MAX_T: the greedy eval covers an episode
GAME_EVAL_STEPS = 50             # the greedy eval of the other games' short epoch
GAME_SYNC_SIMS, GAME_SYNC_STEPS = 16, 40  # the jax:breakout sync run: players, steps an epoch
#: docs/RECIPES.md's flags of each game (the anneals left out: one epoch)
RECIPE = {
    "breakout": ["--reward_clip", "1.0", "--learning_rate", "4e-4", "--entropy_beta", "0.01"],
    "seaquest": ["--reward_clip", "1.0", "--gamma", "0.999", "--learning_rate", "3e-4",
                 "--entropy_beta", "0.02"],
    "qbert": ["--reward_clip", "1.0", "--entropy_beta", "0.006"],
    "coinrun": ["--gamma", "0.999", "--learning_rate", "4e-4", "--entropy_beta", "0.005"],
    "space_invaders": ["--reward_clip", "1.0", "--entropy_beta", "0.01"],
    "boxing": ["--entropy_beta", "0.01"],
    "assault": ["--reward_clip", "1.0", "--entropy_beta", "0.01"],
}


def per_update(T: int, n_chunks: int) -> dict:
    """Launches per fused update: 4 blocks x (T rollout forwards + 1
    bootstrap + 1 a learner chunk); per learner chunk one backward of each
    block: a route each, a dgrad for blocks 1-3, a wgrad each."""
    return {"conv_block_fwd": 4 * (T + 1 + n_chunks), "conv_block_vjp": 4 * n_chunks,
            "conv_block_route": 4 * n_chunks, "conv_block_dgrad": 3 * n_chunks,
            "conv_block_wgrad": 4 * n_chunks}


def _to(draws, dev):
    """A game's draws (a tensor or a NamedTuple of them) on ``dev``."""
    if isinstance(draws, tuple):
        return type(draws)(*(t.to(dev) for t in draws))
    return draws.to(dev)


def games_card_vs_cpu(dev) -> dict:
    """Each game stepped GAME_STEPS times at GAME_ENVS envs on the card and
    on the CPU from the same draws and actions (made once on the CPU, then
    copied): frames, rewards, dones and the discrete state equal at every
    step, the float state within GAME_FLOAT_TOL. Returns each game's
    result: the first step where the two part (none if they never do),
    its episodes and summed reward."""
    import torch

    from distributed_ba3c_tpu_torch.envs import jaxenv

    out = {}
    for game in GAMES:
        env = jaxenv.get_env(game)
        g = torch.Generator().manual_seed(7)
        draws = env.reset_noise(GAME_ENVS, g, "cpu")
        cs, gs = env.reset(draws), env.reset(_to(draws, dev))
        fork, episodes, reward = None, 0, 0.0
        for t in range(-1, GAME_STEPS):
            if t >= 0:
                a = torch.randint(0, env.num_actions, (GAME_ENVS,), generator=g,
                                  dtype=torch.int32)
                draws = env.step_noise(GAME_ENVS, g, "cpu")
                cs, cobs, cr, cd = env.step(cs, a, draws)
                gs, gobs, gr, gd = env.step(gs, a.to(dev), _to(draws, dev))
                episodes += int(cd.sum())
                reward += float(cr.sum())
                parts = {"frames": torch.equal(cobs, gobs.cpu()),
                         "rewards": torch.equal(cr, gr.cpu()), "dones": torch.equal(cd, gd.cpu())}
            else:
                parts = {"frames": torch.equal(env.render(cs), env.render(gs).cpu())}
            for f in env.State._fields:
                a_, b_ = getattr(cs, f), getattr(gs, f).cpu()
                parts[f] = (a_.dtype == b_.dtype and (
                    bool(((a_ - b_).abs() <= GAME_FLOAT_TOL).all()) if a_.is_floating_point()
                    else torch.equal(a_, b_)))
            bad = [k for k, ok in parts.items() if not ok]
            if bad:
                fork = {"step": t, "fields": bad}
                break
        out[game] = {"fork": fork, "episodes": episodes, "reward": reward}
        log(f"[games] {game}: card against CPU, {GAME_ENVS} envs x {GAME_STEPS} steps from "
            f"the same draws: " + (f"PARTED at step {fork['step']} in {fork['fields']}"
                                   if fork else "frames, rewards, dones and state equal")
            + f" ({episodes} episodes ended, reward {reward:g})")
    return out


def _cli_run(argv, dev, tag):
    """One CLI run through ``main`` with the launch counts zeroed first:
    (wall seconds, launches)."""
    from distributed_ba3c_tpu_torch.cli import main as cli_main

    set_launch_counts({k: 0 for k in COUNTED})
    t0 = time.perf_counter()
    rc = cli_main([*argv, "--device", str(dev)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag} {argv} returned {rc}")
    return wall, launch_counts()


def _check_epochs(stats, tag, keys=("loss", "policy_loss", "value_loss", "entropy", "grad_norm")):
    for rec in stats:
        for k in keys:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{tag} epoch {rec['epoch']}: {k} = {rec[k]}")


def _probed_jax_player(idx, name, frame_history, report_dir):
    """``build_jax_player`` wrapped so that the process stepping it writes
    ``torch.cuda.is_initialized()`` to ``report_dir`` at its first action
    and every 500th: the [games] sync run reads them from each child."""
    import multiprocessing

    import torch

    from distributed_ba3c_tpu_torch.envs.base import ProxyPlayer
    from distributed_ba3c_tpu_torch.envs.jaxenv.host_adapter import build_jax_player

    class Probe(ProxyPlayer):
        steps = 0

        def action(self, act):
            out = self.player.action(act)
            self.steps += 1
            if self.steps == 1 or self.steps % 500 == 0:
                path = os.path.join(report_dir, f"{os.getpid()}-{idx}.json")
                with open(path + ".tmp", "w") as f:
                    json.dump({"pid": os.getpid(), "idx": idx, "steps": self.steps,
                               "child": multiprocessing.parent_process() is not None,
                               "cuda_initialized": torch.cuda.is_initialized()}, f)
                os.replace(path + ".tmp", path)
            return out

    return Probe(build_jax_player(idx, name, frame_history))


def games_sync_run(dev) -> dict:
    """``--trainer tpu_sync_ba3c --env jax:breakout`` at full width with
    GAME_SYNC_SIMS host players (simulator children, each stepping one
    Breakout on CPU tensors) for 2 epochs of GAME_SYNC_STEPS learner steps
    (the first holds the children's start, the second is steady): the
    [sync] run's invariants, its samples/s and served p99, and a report
    from every child that it never initialized CUDA."""
    import functools
    import tempfile

    from distributed_ba3c_tpu_torch import cli

    tag = "[games] jax:breakout sync"
    real = cli._build_player_factory
    with tempfile.TemporaryDirectory() as logdir, tempfile.TemporaryDirectory() as reports:
        def probed(args, cfg):
            if not args.env.startswith("jax:"):
                return real(args, cfg)
            return functools.partial(_probed_jax_player, name=args.env.split(":", 1)[1],
                                     frame_history=cfg.frame_history, report_dir=reports)

        cli._build_player_factory = probed
        try:
            run = _sync_run(["--task", "train", "--trainer", "tpu_sync_ba3c",
                             "--env", "jax:breakout", "--simulator_procs", str(GAME_SYNC_SIMS),
                             "--batch_size", str(SYNC_B), "--steps_per_epoch",
                             str(GAME_SYNC_STEPS), "--max_epoch", "2", "--nr_eval", "0",
                             "--logdir", logdir], dev, tag)
        finally:
            cli._build_player_factory = real
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
        child = []
        for name in os.listdir(reports):
            if name.endswith(".json"):
                with open(os.path.join(reports, name)) as f:
                    child.append(json.load(f))
    _check_epochs(stats, tag, ("loss", "entropy", "grad_norm"))
    _sync_checks(run, 2 * GAME_SYNC_STEPS, exact_serving=False, tag=tag,
                 samples_per_step=SYNC_B)
    if run["master"].get("per_env_msgs_total", 0) <= 0:
        raise AssertionError(f"{tag}: no per-env message reached the master")
    children = {r["pid"] for r in child if r["child"]}
    cuda = [r for r in child if r["cuda_initialized"]]
    log(f"{tag}: {len(children)} simulator children reported (pids {sorted(children)}); "
        f"CUDA initialized in {len(cuda)} of them")
    if len(children) != GAME_SYNC_SIMS or any(not r["child"] for r in child):
        raise AssertionError(f"{tag}: reports from {len(children)} children, expected "
                             f"{GAME_SYNC_SIMS}: {child}")
    if cuda:
        raise AssertionError(f"{tag}: a simulator child initialized CUDA: {cuda}")
    numbers = _sync_numbers(run, 2 * GAME_SYNC_STEPS)
    numbers["fps"] = [r["fps"] for r in stats]
    log(f"{tag}: " + ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in numbers.items()))
    return {"launches": run["launches"], "numbers": numbers,
            "children": len(children), "children_with_cuda": len(cuda)}


def phase_games(dev) -> dict:
    """The on-device game set. (1) Card against CPU: every game of GAMES
    (:func:`games_card_vs_cpu`). (2) BASELINE config #5 through the CLI:
    ``--trainer tpu_fused_ba3c --env jax:coinrun --batch_size 20480
    --rollout_len 20 --gamma 0.999`` at full width, 2 epochs of CR_UPDATES
    updates with a 1000-step greedy eval of 8 envs each, a ``--load``
    epoch, and ``--task eval --load`` through host players; launches per
    update counted (4 x (20 + 1 + 5) forwards, 20 route, 15 dgrad, 20
    wgrad), and the same through the step API with the update's parts
    timed; a learner chunk's gradients at B=4096 of CoinRun states, kernels
    against plain blocks, with its peak memory; the four blocks' forward
    and backward timed at B=4096 beside the plain and library versions.
    (3) The six other games: one fused CLI epoch of 2 updates each at 128
    envs x 20 with docs/RECIPES.md's flags: exact launches, finite loss.
    (4) The sync trainer on ``jax:breakout`` host players
    (:func:`games_sync_run`)."""
    import tempfile

    import torch

    from distributed_ba3c_tpu_torch.parallel.train_step import n_grad_chunks

    tag = "[games]"
    t0 = time.perf_counter()
    launches = {}
    card_cpu = games_card_vs_cpu(dev)
    forks = {g: r["fork"] for g, r in card_cpu.items() if r["fork"]}
    if forks:
        raise AssertionError(f"{tag} card and CPU parted: {forks}")

    # (2) BASELINE config #5
    cr_chunks = n_grad_chunks(CR_B, CR_CHUNK)
    cr_update = per_update(CR_T, cr_chunks)
    cr = ["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "jax:coinrun",
          "--batch_size", str(CR_B), "--rollout_len", str(CR_T), *RECIPE["coinrun"],
          "--grad_chunk_samples", str(CR_CHUNK),
          "--steps_per_epoch", str(CR_UPDATES), "--nr_eval", "8",
          "--eval_max_steps", str(CR_EVAL_STEPS)]
    runs = {}
    with tempfile.TemporaryDirectory() as logdir:
        ckdir = os.path.join(logdir, "checkpoints")
        for name, extra, updates in (("train", ["--max_epoch", "2"], 2 * CR_UPDATES),
                                     ("resumed", ["--max_epoch", "3", "--load", ckdir],
                                      CR_UPDATES)):
            wall, got = _cli_run([*cr, *extra, "--logdir", logdir], dev, f"{tag} coinrun {name}")
            evals = updates // CR_UPDATES
            want = {k: updates * n for k, n in cr_update.items()}
            want["conv_block_fwd"] += evals * CR_EVAL_STEPS * 4
            runs[name] = {"wall_s": wall, "launches": got}
            launches[f"coinrun_{name}"] = got
            log(f"{tag} coinrun {name}: {wall:.2f} s, launches {got} (expected {want}: "
                f"per update {cr_update}, {CR_EVAL_STEPS * 4} forwards a greedy eval)")
            if got != want:
                raise AssertionError(f"{tag} coinrun {name} launches {got}, expected {want}")
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
        if [int(r["global_step"]) for r in stats] != [CR_UPDATES * e for e in (1, 2, 3)]:
            raise AssertionError(f"{tag} coinrun --load did not continue: {stats}")
        _check_epochs(stats, f"{tag} coinrun")
        wall, got = _cli_run(["--task", "eval", "--env", "jax:coinrun", "--nr_eval", "4",
                              "--max_steps", "300", "--load", ckdir], dev,
                             f"{tag} coinrun eval --load")
        launches["coinrun_eval"] = got
        if got["conv_block_fwd"] == 0:
            raise AssertionError(f"{tag} coinrun --task eval --load never launched the forward")
    cr_numbers = {
        "fps": [r["fps"] for r in stats],
        "eval_mean_score": [r.get("eval_mean_score") for r in stats],
        "mean_score": [r.get("mean_score") for r in stats],
        "loss": [r["loss"] for r in stats],
        "wall_s": {k: v["wall_s"] for k, v in runs.items()},
        "eval_load_wall_s": wall,
    }
    log(f"{tag} coinrun cli: stat.json env-steps/s {cr_numbers['fps']}; eval_mean_score "
        f"{cr_numbers['eval_mean_score']}; loss {cr_numbers['loss']}")
    saved = launch_counts()
    cr_step = phase_train_step(dev, "coinrun", CR_ENVS, CR_T, CR_CHUNK, tag=f"{tag} coinrun")
    if cr_step["launches_per_update"] != cr_update:
        raise AssertionError(f"{tag} coinrun launches per update {cr_step['launches_per_update']}")
    from distributed_ba3c_tpu_torch.envs import jaxenv

    coinrun = jaxenv.get_env("coinrun")
    states = game_train_states(coinrun, dev, CR_ENVS, CR_CHUNK // CR_ENVS, seed=3)
    grad = phase_train_grads(dev, states, coinrun.num_actions, tag=f"{tag} coinrun")
    vjp = phase_vjp(dev, states, detail=True)
    set_launch_counts(saved)
    del states
    cr_numbers["learner_peak_gib"] = grad["peak_bytes"]["cuda"] / 2**30
    cr_numbers["learner_call_peak_gib"] = grad["call_peak_bytes"]["cuda"] / 2**30
    cr_numbers["plain_learner_peak_gib"] = grad["peak_bytes"]["torch"] / 2**30
    log(f"{tag} coinrun learner chunk B={CR_CHUNK}: peak memory "
        f"{cr_numbers['learner_peak_gib']:.3f} GiB ({cr_numbers['learner_call_peak_gib']:.3f} "
        f"above the call's start; plain blocks {cr_numbers['plain_learner_peak_gib']:.3f}); "
        f"four blocks fwd+bwd {sum(r['ms'] for r in vjp):.3f} ms (plain "
        f"{sum(r['plain_ms'] for r in vjp):.3f}, library {sum(r['library_ms'] for r in vjp):.3f})")

    # (3) the six other games, one short fused epoch each
    others = {}
    for game in GAMES:
        if game == "coinrun":
            continue
        with tempfile.TemporaryDirectory() as logdir:
            wall, got = _cli_run(
                ["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", f"jax:{game}",
                 "--batch_size", str(TRAIN_B), "--rollout_len", str(TRAIN_T), *RECIPE[game],
                 "--steps_per_epoch", "2", "--max_epoch", "1", "--nr_eval", "4",
                 "--eval_max_steps", str(GAME_EVAL_STEPS), "--logdir", logdir],
                dev, f"{tag} {game}")
            with open(os.path.join(logdir, "stat.json")) as f:
                rec = json.load(f)[-1]
        want = {k: 2 * n for k, n in PER_UPDATE.items()}
        want["conv_block_fwd"] += GAME_EVAL_STEPS * 4
        _check_epochs([rec], f"{tag} {game}")
        others[game] = {"wall_s": wall, "fps": rec["fps"], "loss": rec["loss"],
                        "entropy": rec["entropy"]}
        launches[game] = got
        log(f"{tag} {game} fused epoch: {wall:.2f} s, env-steps/s {rec['fps']:.1f}, loss "
            f"{rec['loss']:.5f}, entropy {rec['entropy']:.4f}, launches {got}")
        if got != want:
            raise AssertionError(f"{tag} {game} launches {got}, expected {want}")

    # (4) host players on the ZMQ plane
    sync = games_sync_run(dev)
    launches["breakout_sync"] = sync["launches"]
    wall = time.perf_counter() - t0
    log(f"{tag} phase {wall:.2f} s")
    return {"wall_s": wall, "card_vs_cpu": card_cpu, "coinrun": cr_numbers,
            "coinrun_step": cr_step, "coinrun_grad_rel_l2": grad["rel_l2"], "vjp_rows": vjp,
            "others": others, "sync": sync["numbers"], "sync_children": sync["children"],
            "launches": launches}


#: the launch counts the paths are read by: each kernel wrapper's, and
#: conv_block's backward passes on the card (conv_block_vjp)
TRACE_N = 8               # --trace_sample: 1 in 8 block steps of each env server traced
TRACE_VT_STEPS = 40       # learner steps of the traced V-trace epoch
TRACE_PAIRS = 3           # alternating untraced/traced pairs of the plane alone
TRACE_PLANE_S = 3.0       # seconds each plane-alone window measures
TRACE_FLOOR = 0.90        # the traced/untraced median below which [trace] fails
TRACE_JAX_BOUND = 0.98    # the JAX package's gate (docs/observability.md), reported
TRACE_MIN_CHAINS = 5      # complete chains a traced epoch must show
#: each hop's role, and the hop it is parented on (the main chain's
#: predecessor, or the span a branch hangs from; docs/observability.md)
HOP_ROLE = {"env_step": "master", "wire": "master", "master_ingest": "master",
            "predict": "master", "nstep_flush": "master", "unroll_flush": "master",
            "predict_dispatch": "predictor", "predict_fetch": "predictor",
            "queue_wait": "learner", "staging_wait": "learner", "collate": "learner",
            "h2d_copy": "learner", "ingest": "learner", "learner_step": "learner"}
TRACE_BRANCHES = {"predict_dispatch": "master_ingest", "predict_fetch": "predict_dispatch",
                  "staging_wait": "queue_wait"}
#: the hand-written kernels as a capture names them, and the wrappers
#: whose launches each symbol counts (a forward launch is its
#: conv_block_kernel, a route its route_kernel, a dgrad its dgrad_kernel;
#: a wgrad launch is its wgrad_kernel and then its wgrad_reduce_kernel)
KERNEL_SYMBOLS = {"wgrad_reduce_kernel": ("conv_block_wgrad",),
                  "wgrad_kernel": ("conv_block_wgrad",),
                  "dgrad_kernel": ("conv_block_dgrad",),
                  "route_kernel": ("conv_block_route",),
                  "conv_block_kernel": ("conv_block_fwd",)}
#: the capture's kernel events a sync learner step (B=128): 4 forwards, 4
#: routes, 3 dgrads, 4 wgrads of two kernels each
STEP_KERNEL_EVENTS = {"wgrad_reduce_kernel": 4, "wgrad_kernel": 4, "dgrad_kernel": 3,
                      "route_kernel": 4, "conv_block_kernel": 4}


def trace_chain(flush: str) -> tuple:
    return ("env_step", "wire", "master_ingest", "predict", flush, "queue_wait",
            "collate", "h2d_copy", "ingest", "learner_step")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Scraper(threading.Thread):
    """Scrapes /metrics, /trace and /flight of a live run every 0.5 s over
    HTTP and keeps the newest answer of each (the endpoint dies with the
    run)."""

    def __init__(self, port: int):
        super().__init__(daemon=True, name="trace-scraper")
        self.base = f"http://127.0.0.1:{port}"
        self.last = {}
        self.scrapes = 0
        self.stop_evt = threading.Event()

    def get(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=10) as r:
            return r.read()

    def run(self) -> None:
        while not self.stop_evt.wait(0.5):
            for path in ("/metrics", "/trace", "/flight?kind=checkpoint", "/flight"):
                try:
                    self.last[path] = self.get(path)
                except OSError:
                    continue  # not up yet, or gone
                if path == "/metrics":
                    self.scrapes += 1


def _scraped_run(fn, port: int):
    """``fn()`` with a scraper on ``port`` beside it: (fn's result, scraper)."""
    scraper = _Scraper(port)
    scraper.start()
    try:
        out = fn()
    finally:
        scraper.stop_evt.set()
        scraper.join(10)
    return out, scraper


def trace_chains(doc: dict, flush: str, tag: str) -> dict:
    """Checks every trace of a /trace document that reached the learner:
    the whole chain present, each hop parented on the one before it (the
    branches on theirs), under its role, starts in chain order, no
    negative duration. Returns the counts."""
    chain = trace_chain(flush)
    traces = {}
    for sp in doc["spans"]:
        if sp["dur_us"] < 0:
            raise AssertionError(f"{tag} negative duration: {sp}")
        traces.setdefault(sp["trace_id"], {}).setdefault(sp["name"], sp)
    done = [by for by in traces.values() if "learner_step" in by]
    for by in done:
        missing = [h for h in chain + tuple(TRACE_BRANCHES) if h not in by]
        if missing:
            raise AssertionError(f"{tag} trace {by['learner_step']['trace_id']} lacks {missing}")
        parents = dict(zip(chain[1:], chain)) | TRACE_BRANCHES
        for hop, parent in parents.items():
            if by[hop]["parent_id"] != by[parent]["span_id"]:
                raise AssertionError(f"{tag} {hop} is not parented on {parent}: {by}")
        for hop, sp in by.items():
            if hop in HOP_ROLE and sp["role"] != HOP_ROLE[hop]:
                raise AssertionError(f"{tag} {hop} recorded under {sp['role']}")
        starts = [by[h]["ts_us"] for h in chain]
        if starts != sorted(starts):
            raise AssertionError(f"{tag} chain starts out of order: {starts}")
    if len(done) < TRACE_MIN_CHAINS:
        raise AssertionError(f"{tag} {len(done)} complete chains (< {TRACE_MIN_CHAINS}) "
                             f"of {len(traces)} traces")
    return {"traces": len(traces), "complete_chains": len(done)}


def hop_split(doc: dict) -> dict:
    """Median and p99 (nearest rank) of each hop's duration in ms, over
    every span of the document."""
    import numpy as np

    durs = {}
    for sp in doc["spans"]:
        durs.setdefault(sp["name"], []).append(sp["dur_us"] / 1e3)
    return {name: {"n": len(v), "median_ms": float(np.median(v)),
                   "p99_ms": float(np.sort(v)[min(len(v) - 1, int(0.99 * len(v)))])}
            for name, v in durs.items()}


def trace_dump_validates(doc: dict, tag: str) -> int:
    """The /trace document through scripts/trace_dump.py --validate (a
    subprocess, as a user runs it); returns the complete events it wrote."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "trace.json"), os.path.join(d, "chrome.json")
        with open(src, "w") as f:
            json.dump(doc, f)
        r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "trace_dump.py"),
                            src, "-o", out, "--validate"],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise AssertionError(f"{tag} scripts/trace_dump.py --validate failed: "
                                 f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
        with open(out) as f:
            return sum(1 for e in json.load(f)["traceEvents"] if e.get("ph") == "X")


def hop_histograms(metrics: str, hops, tag: str) -> None:
    """Each hop's hop_<name>_s histogram is on /metrics under its role."""
    for hop in hops:
        line = f'ba3c_hop_{hop}_s_count{{role="{HOP_ROLE[hop]}"}}'
        if line not in metrics:
            raise AssertionError(f"{tag} /metrics has no {line}")


def trace_capture(dev, states) -> dict:
    """``utils/profiling.py::capture_trace`` around two sampled learner
    steps of the sync trainer's ``Trainer.run_step`` at B=SYNC_B (a feed
    whose batches carry a trace ref): the Chrome JSON must hold each
    step's ``step_annotation`` range with its trace and span ids, and the
    hand-written kernels by symbol, launched inside those ranges, as many
    as the launch counters counted."""
    import tempfile

    import numpy as np
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )
    from distributed_ba3c_tpu_torch.telemetry import tracing
    from distributed_ba3c_tpu_torch.train.trainer import Trainer, TrainLoopConfig
    from distributed_ba3c_tpu_torch.utils import profiling

    tag = "[trace]"
    x = np.concatenate(states)[:SYNC_B]
    rng = np.random.default_rng(5)

    class Feed:
        """Batches of the sync feed's layout; from the second on, each
        carries a trace ref (ids from the sender's make_id)."""

        def __init__(self):
            self.n = 0

        def next_batch(self, timeout=None):
            self.n += 1
            b = {"state": x, "action": rng.integers(0, 6, SYNC_B).astype(np.int32),
                 "return": rng.standard_normal(SYNC_B).astype(np.float32)}
            if self.n > 1:
                b["_trace"] = tracing.TraceRef(tracing.make_id(b"capture", self.n), 1)
            return b

    cfg = BA3CConfig(batch_size=SYNC_B)
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_train_state(net, cfg)
    trainer = Trainer(TrainLoopConfig(), cfg, make_train_step(net, state.optimizer, cfg),
                      state, Feed(), [])
    trainer.run_step()  # untraced: the first call's allocations stay out
    torch.cuda.synchronize()
    tracing.reset()
    set_launch_counts({k: 0 for k in COUNTED})
    def steps():
        # CUPTI can drop the first kernels of a capture (seen after other
        # captures in the process): plain PyTorch kernels first, whose names
        # match no KERNEL_SYMBOLS, so the two annotated steps are whole
        warm = torch.ones((512, 512), device=dev)
        for _ in range(32):
            warm = torch.tanh(warm @ warm)
        torch.cuda.synchronize()
        return [trainer.run_step() for _ in range(2)]

    with tempfile.TemporaryDirectory() as d:
        profiling.capture_trace(d, 0, steps)
        launches = launch_counts()
        with open(os.path.join(d, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    steps = {s["parent_id"]: s for s in tracing.tracer().spans.snapshot()
             if s["name"] == "learner_step"}
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("train_step step=")),
                    key=lambda e: e["ts"])
    if len(ranges) != 2:
        raise AssertionError(f"{tag} {len(ranges)} step_annotation ranges in the capture "
                             f"(want 2): {[e.get('name') for e in ranges]}")
    for e in ranges:
        ids = dict(kv.split("=") for kv in e["name"].split()[1:])
        sp = steps.get(int(ids["span_id"]))
        if sp is None or sp["trace_id"] != int(ids["trace_id"]):
            raise AssertionError(f"{tag} range {e['name']!r} names no learner_step span")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    per_step = [{k: 0 for k in KERNEL_SYMBOLS} for _ in ranges]
    how = {"launch_in_range": 0, "gpu_time_after_range_start": 0}
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        sym = next((k for k in KERNEL_SYMBOLS if k in e.get("name", "")), None)
        if sym is None:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is not None:  # the launch call lies inside a step's range
            i = next((i for i, r in enumerate(ranges) if r["ts"] <= t <= r["ts"] + r["dur"]),
                     None)
            how["launch_in_range"] += 1
        else:  # no launch event: the step whose range began last before it ran
            i = max((i for i, r in enumerate(ranges) if r["ts"] <= e["ts"]), default=None)
            how["gpu_time_after_range_start"] += 1
        if i is None:
            raise AssertionError(f"{tag} {sym} ran outside the annotated steps")
        per_step[i][sym] += 1
    want = {sym: sum(launches[w] for w in wrappers) // 2
            for sym, wrappers in KERNEL_SYMBOLS.items()}
    log(f"{tag} capture: annotated ranges {[e['name'] for e in ranges]}; kernel events per "
        f"step {per_step} (the launch counters: {launches}, so {want} a step); kernels "
        f"placed by {how}; event categories {cats}")
    if any(n != want for n in per_step) or want != STEP_KERNEL_EVENTS:
        raise AssertionError(f"{tag} the capture's kernel events {per_step} do not match the "
                             f"launch counters ({want} a step, {STEP_KERNEL_EVENTS} expected)")
    return {"per_step": per_step, "launches": launches, "placed_by": how,
            "ranges": [e["name"] for e in ranges]}


def trace_flight_dump(dev) -> dict:
    """SIGTERM a short traced sync run (a separate process, its own logdir):
    ``flight-<pid>.json`` must be there with the JAX document's keys."""
    import signal
    import tempfile

    tag = "[trace]"
    with tempfile.TemporaryDirectory() as logdir:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_ba3c_tpu_torch", "--task", "train",
             "--trainer", "tpu_sync_ba3c", "--env", "fake", "--simulator_procs", "2",
             "--batch_size", "16", "--steps_per_epoch", "100000", "--max_epoch", "1",
             "--nr_eval", "0", "--trace_sample", str(TRACE_N), "--device", str(dev),
             "--logdir", logdir],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        started = threading.Event()
        tail = []

        def read():
            for line in proc.stderr:
                tail.append(line)
                if "StartProcOrThread: started" in line:
                    started.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            if not started.wait(120):
                raise AssertionError(f"{tag} the run to SIGTERM never started: {''.join(tail)[-2000:]}")
            time.sleep(2.0)  # a few learner steps
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(60)
        finally:
            for sig in (signal.SIGTERM, signal.SIGKILL):  # its children, and anything left
                try:
                    os.killpg(proc.pid, sig)
                except ProcessLookupError:
                    break
                time.sleep(1.0)
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            reader.join(10)
        path = os.path.join(logdir, f"flight-{proc.pid}.json")
        if not os.path.exists(path):
            raise AssertionError(f"{tag} no {os.path.basename(path)} after SIGTERM (rc {rc}): "
                                 f"{os.listdir(logdir)}; {''.join(tail)[-2000:]}")
        with open(path) as f:
            doc = json.load(f)
    keys = {"reason", "pid", "dumps", "anchor_monotonic", "anchor_wall", "events"}
    kinds = [e["kind"] for e in doc["events"]]
    if set(doc) != keys or doc["reason"] != "SIGTERM" or doc["pid"] != proc.pid \
            or "sigterm" not in kinds:
        raise AssertionError(f"{tag} flight dump {sorted(doc)}, reason {doc.get('reason')}, "
                             f"kinds {kinds}")
    log(f"{tag} SIGTERM: flight-{proc.pid}.json with keys {sorted(doc)}, {len(kinds)} events "
        f"({sorted(set(kinds))}); exit {rc}")
    return {"rc": rc, "events": len(kinds), "kinds": sorted(set(kinds))}


def trace_fused(dev) -> dict:
    """Two fused epochs (128 envs x 20, 5 updates each) with
    ``--telemetry_port``: /metrics serves the learner's counters while the
    run lasts (train_steps_total past the first epoch's), and the logdir
    holds TensorBoard events whose tags are stat.json's keys and a
    channels.jsonl."""
    import tempfile

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from distributed_ba3c_tpu_torch import telemetry

    tag = "[trace]"
    c_steps = telemetry.registry("learner").counter("train_steps_total")
    base = c_steps.value()
    port = _free_port()
    with tempfile.TemporaryDirectory() as logdir:
        (wall, launches), scraper = _scraped_run(lambda: _cli_run(
            ["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "jax:pong",
             "--batch_size", str(TRAIN_B), "--rollout_len", str(TRAIN_T),
             "--steps_per_epoch", "5", "--max_epoch", "2", "--nr_eval", "8",
             "--eval_max_steps", "50", "--telemetry_port", str(port), "--logdir", logdir],
            dev, tag), port)
        with open(os.path.join(logdir, "stat.json")) as f:
            stats = json.load(f)
        acc = EventAccumulator(logdir)
        acc.Reload()
        tags = set(acc.Tags()["scalars"])
        with open(os.path.join(logdir, "channels.jsonl")) as f:
            channels = [json.loads(x) for x in f]
    metrics = scraper.last.get("/metrics", b"").decode()
    served = next((float(x.split()[-1]) for x in metrics.splitlines()
                   if x.startswith('ba3c_train_steps_total{role="learner"}')), None)
    keys = {k for r in stats for k in r if k != "global_step"}
    log(f"{tag} fused, --telemetry_port: {scraper.scrapes} scrapes, train_steps_total served "
        f"{served} (run start {base}); {len(tags)} TensorBoard tags, {len(keys)} stat.json keys; "
        f"{len(channels)} channel points; {wall:.2f} s")
    if served is None or served < base + 5:
        raise AssertionError(f"{tag} /metrics never served the learner's counters past epoch 1")
    if tags != keys:
        raise AssertionError(f"{tag} TensorBoard tags {sorted(tags ^ keys)} differ from stat.json's")
    if [p["x"] for p in channels if p["channel"] == "loss"] != [5, 10]:
        raise AssertionError(f"{tag} channels.jsonl {channels}")
    want = {k: 10 * n for k, n in PER_UPDATE.items()}
    want["conv_block_fwd"] += 2 * 50 * 4
    if launches != want:
        raise AssertionError(f"{tag} fused launches {launches}, expected {want}")
    return {"wall_s": wall, "launches": launches, "tb_tags": len(tags),
            "scrapes": scraper.scrapes}


def phase_trace(dev, states) -> dict:
    """The telemetry plane on the card. (1) The sync trainer as [sync] runs
    it (cpp:pong, 4 block-shm servers x 16 envs, B=128) with
    ``--trace_sample 8 --telemetry_port`` for one epoch, scraped over HTTP
    while it runs: every trace that reached the learner holds the whole
    chain env_step -> ... -> learner_step, each hop parented on the one
    before it (dispatch/fetch and staging_wait as branches), under its
    role, in order, no negative duration; each hop's histogram on
    /metrics; /trace valid through scripts/trace_dump.py; 4/4/3/4 launches
    a learner step. The hops' median and p99, and the host shares of a
    served batch and of a learner step. (2) One V-trace epoch, traced: its
    chains run through unroll_flush. (3) Overhead: TRACE_PAIRS alternating
    pairs of the plane alone, untraced and traced, the order flipped
    between pairs; the median traced/untraced rows/s (fails below
    TRACE_FLOOR). (4) ``capture_trace`` around two sampled learner steps
    (:func:`trace_capture`). (5) A SIGTERM flight dump
    (:func:`trace_flight_dump`). (6) The fused trainer's scrape endpoint,
    TensorBoard events and channels (:func:`trace_fused`)."""
    import tempfile

    from distributed_ba3c_tpu_torch.telemetry import tracing

    tag = "[trace]"
    t_phase = time.perf_counter()
    base = ["--task", "train", "--batch_size", str(SYNC_B), "--nr_eval", "0",
            "--env", "cpp:pong", "--wire", "block-shm", "--simulator_procs", str(SYNC_SIMS),
            "--trace_sample", str(TRACE_N), "--max_epoch", "1"]
    out = {"launches": {}}
    try:
        for name, trainer, steps, flush, extra in (
                ("sync", "tpu_sync_ba3c", SYNC_STEPS, "nstep_flush", []),
                ("vtrace", "tpu_vtrace_ba3c", TRACE_VT_STEPS, "unroll_flush",
                 ["--local_time_max", str(VT_T)])):
            tracing.reset()
            port = _free_port()
            with tempfile.TemporaryDirectory() as logdir:
                run, scraper = _scraped_run(lambda: _sync_run(
                    [*base, "--trainer", trainer, "--steps_per_epoch", str(steps), *extra,
                     "--telemetry_port", str(port), "--logdir", logdir], dev, tag), port)
            _sync_checks(run, steps, exact_serving=True, tag=tag,
                         samples_per_step=SYNC_B if name == "sync" else VT_SEGS * VT_T)
            out["launches"][name] = run["launches"]
            if "/trace" not in scraper.last or "/metrics" not in scraper.last:
                raise AssertionError(f"{tag} {name}: nothing scraped ({scraper.scrapes} scrapes)")
            doc = json.loads(scraper.last["/trace"])
            metrics = scraper.last["/metrics"].decode()
            flight = json.loads(scraper.last["/flight"])
            counts = trace_chains(doc, flush, f"{tag} {name}")
            hop_histograms(metrics, trace_chain(flush) + tuple(TRACE_BRANCHES), f"{tag} {name}")
            n_events = trace_dump_validates(doc, f"{tag} {name}")
            split = hop_split(doc)
            out[name] = {"wall_s": run["wall_s"], "scrapes": scraper.scrapes, **counts,
                         "spans": len(doc["spans"]), "dropped_spans": doc["dropped_spans"],
                         "trace_dump_events": n_events, "flight_events": len(flight),
                         "clock_peers": len(doc["clock_offsets_us"]), "split": split,
                         "numbers": _sync_numbers(run, steps)}
            log(f"{tag} {name}: {counts['complete_chains']} complete chains of "
                f"{counts['traces']} traces, {len(doc['spans'])} spans, "
                f"{len(doc['clock_offsets_us'])} clock peers, trace_dump.py {n_events} events "
                f"valid; {scraper.scrapes} scrapes; {run['wall_s']:.2f} s")
            log(f"{tag} {name} hops, ms (n, median, p99): " + "; ".join(
                f"{h} {v['n']} {v['median_ms']:.4g} {v['p99_ms']:.4g}"
                for h, v in sorted(split.items(), key=lambda kv: -kv[1]["median_ms"])))
            if name == "sync":
                med = {h: v["median_ms"] for h, v in split.items()}
                served = med["predict_dispatch"] / (med["predict_dispatch"] + med["predict_fetch"])
                host = med["queue_wait"] + med["collate"] + med["ingest"]
                out["host_share"] = {
                    "served_batch_dispatch_share": served,
                    "learner_feed_ms": host, "learner_step_ms": med["learner_step"],
                    "learner_feed_share": host / (host + med["learner_step"])}
                log(f"{tag} host shares (medians): a served batch's predict_dispatch "
                    f"{med['predict_dispatch']:.4g} ms against predict_fetch "
                    f"{med['predict_fetch']:.4g} ms (dispatch share {served:.3f}); the learner's "
                    f"queue_wait + collate + ingest {host:.4g} ms against learner_step "
                    f"{med['learner_step']:.4g} ms (feed share {out['host_share']['learner_feed_share']:.3f})")
    finally:
        tracing.set_sampling(0)
        os.environ.pop("BA3C_TRACE", None)
        tracing.reset()

    rates = {"untraced": [], "traced": []}
    for i in range(TRACE_PAIRS):
        order = (0, TRACE_N) if i % 2 == 0 else (TRACE_N, 0)
        for n in order:
            r = phase_plane_alone(dev, seconds=TRACE_PLANE_S, trace_sample=n, tag=tag)
            rates["traced" if n else "untraced"].append(r["predictor_rows_per_s"])
    import numpy as np

    ratio = float(np.median(rates["traced"]) / np.median(rates["untraced"]))
    out["overhead"] = {"rows_per_s": rates, "median_ratio": ratio,
                       "meets_jax_bound": ratio >= TRACE_JAX_BOUND}
    log(f"{tag} overhead, plane alone, {TRACE_PAIRS} alternating pairs: rows/s untraced "
        f"{rates['untraced']}, traced {rates['traced']}; median traced/untraced {ratio:.4f} "
        f"({'meets' if ratio >= TRACE_JAX_BOUND else 'misses'} the JAX bound {TRACE_JAX_BOUND}; "
        f"fails below {TRACE_FLOOR})")
    if ratio < TRACE_FLOOR:
        raise AssertionError(f"{tag} tracing costs the plane {1 - ratio:.1%} (ratio {ratio:.4f})")
    tracing.reset()

    out["capture"] = trace_capture(dev, states)
    out["launches"]["capture"] = out["capture"]["launches"]
    out["flight"] = trace_flight_dump(dev)
    out["fused"] = trace_fused(dev)
    out["launches"]["fused"] = out["fused"]["launches"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase {out['wall_s']:.1f} s")
    return out


COUNTED = ("conv_block_fwd", "conv_block_vjp", "conv_block_route", "conv_block_dgrad",
           "conv_block_wgrad")


def _counters():
    from distributed_ba3c_tpu_torch.ops import conv_block as cb

    return {"conv_block_fwd": cb.conv_block_fwd, "conv_block_vjp": cb.conv_block,
            "conv_block_route": cb.conv_block_route, "conv_block_dgrad": cb.conv_block_dgrad,
            "conv_block_wgrad": cb.conv_block_wgrad}


def launch_counts() -> dict:
    return {k: f.launches for k, f in _counters().items()}


def set_launch_counts(counts: dict) -> None:
    for k, f in _counters().items():
        f.launches = counts[k]


#: launches per training update at 128 envs x 20 (one learner chunk)
PER_UPDATE = per_update(TRAIN_T, 1)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--parity", action="store_true",
                    help="only build the kernels and hold each against its plain "
                         "version (a new kernel's first call); prints no result")
    ap.add_argument("--sync-probe", metavar="S[:P],...",
                    help="only build and run the [sync] cpp:pong run (one epoch) under "
                         "each interpreter switch interval S (seconds) and "
                         "--predict_batch_size P (default 16), then the actor plane "
                         "without its learner; prints no result")
    ap.add_argument("--trace", action="store_true",
                    help="only build and run the [trace] phase (the telemetry plane); "
                         "prints no result")
    ap.add_argument("--kernel-times", metavar="B,B,...",
                    help="only build, hold every block's forward against its plain "
                         "version and time it and each backward kernel at these "
                         "batches; prints one JSON line, no result")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributed_ba3c_tpu_torch.ops.conv_block import conv_block_fwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no answer"
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}; {card}")
    probe = phase_env_probe(card)

    phase_build()
    if args.sync_probe:
        import tempfile

        for entry in args.sync_probe.split(","):
            interval, _, pbs = entry.partition(":")
            interval, pbs = float(interval), int(pbs or 16)
            sys.setswitchinterval(interval)
            with tempfile.TemporaryDirectory() as logdir:
                run = _sync_run(["--task", "train", "--trainer", "tpu_sync_ba3c",
                                 "--batch_size", str(SYNC_B), "--steps_per_epoch",
                                 str(SYNC_STEPS), "--nr_eval", "0", "--env", "cpp:pong",
                                 "--wire", "block-shm", "--simulator_procs", str(SYNC_SIMS),
                                 "--predict_batch_size", str(pbs),
                                 "--max_epoch", "1", "--logdir", logdir], dev)
            log(f"[sync-probe] switch interval {interval} s, predict_batch_size {pbs}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in _sync_numbers(run, SYNC_STEPS).items()))
        sys.setswitchinterval(0.005)
        phase_plane_alone(dev)
        return 0
    if args.trace:
        phase_trace(dev, pong_states(8)[0])
        return 0
    if args.parity:
        phase_kernels(dev, timed_batches=())
        phase_bwd_kernels(dev)
        log("[parity] every kernel agrees with its plain version; nothing was timed")
        return 0
    if args.kernel_times:
        batches = tuple(int(b) for b in args.kernel_times.split(","))
        rows_by_b, _ = phase_kernels(dev, batches=batches, timed_batches=batches)
        log("[kernel-times] " + json.dumps({"root": ROOT, "ms": {
            nb: {r["block"]: r["ms"] for r in rows} for nb, rows in rows_by_b.items()},
            "bwd_ms": {nb: phase_bwd_times(dev, nb) for nb in batches}}))
        return 0
    rows_by_b, kernel_err = phase_kernels(dev)
    rows = rows_by_b[B]
    states, num_actions = pong_states(8)
    model, fwd = phase_model(dev, states)

    conv_block_fwd.launches = 0
    serve = phase_serving(dev, model, states, num_actions)
    serve_launches = conv_block_fwd.launches
    log(f"[serve] conv_block_fwd launches: {serve_launches} "
        f"({serve_launches / max(serve['batches'] + WARMUP_BUCKETS, 1):.2f} per forward)")
    if serve_launches == 0:
        raise AssertionError("the serving path never launched conv_block_fwd")

    conv_block_fwd.launches = 0
    phase_play(dev)
    play_launches = conv_block_fwd.launches
    log(f"[play] conv_block_fwd launches: {play_launches}")
    if play_launches == 0:
        raise AssertionError("--task play never launched conv_block_fwd")

    bwd_err = phase_bwd_kernels(dev)
    train_states = pong_train_states(dev)
    other = phase_vjp(dev, train_states, rules="pallas", detail=False)
    log(f"[vjp] block_rules=pallas (reference_block on blocks 1-3): four blocks fwd+bwd "
        f"{sum(r['ms'] for r in other):.3f} ms at B={TRAIN_B}")
    vjp_rows = phase_vjp(dev, train_states, rules="xla")
    log(f"[vjp] block_rules=xla (flax's rule on every block, the trainer's): four blocks "
        f"fwd+bwd {sum(r['ms'] for r in vjp_rows):.3f} ms at B={TRAIN_B}")
    grad = phase_train_grads(dev, train_states)
    del train_states
    set_launch_counts({k: 0 for k in COUNTED})
    train = phase_train_cli(dev)
    train_launches = launch_counts()
    # per update PER_UPDATE; and 4 forwards per greedy-eval step
    want = {k: train["updates"] * n for k, n in PER_UPDATE.items()}
    want["conv_block_fwd"] += train["evals"] * train["eval_steps"] * 4
    log(f"[train] cli launches: {train_launches} (expected {want}: per update {PER_UPDATE}, "
        f"800 conv_block_fwd per eval)")
    if train_launches != want:
        raise AssertionError(f"train launches {train_launches}, expected {want}")
    step = phase_train_step(dev)
    if step["launches_per_update"] != PER_UPDATE:
        raise AssertionError(f"launches per update: {step['launches_per_update']}")

    resume = phase_resume(dev, states)
    # 4 updates over the three runs, and a greedy eval in each of the 2 epochs
    want = {k: 4 * n for k, n in PER_UPDATE.items()}
    want["conv_block_fwd"] += 2 * 200 * 4
    if resume["launches"]["train"] != want:
        raise AssertionError(f"[resume] train launches {resume['launches']['train']}, expected {want}")
    for part in ("eval", "play"):
        if resume["launches"][part]["conv_block_fwd"] == 0:
            raise AssertionError(f"[resume] {part} --load never launched conv_block_fwd")
    resume_fwd = sum(v["conv_block_fwd"] for v in resume["launches"].values())

    sync = phase_sync(dev, states)
    sync_launches = {k: sum(v[k] for v in sync["launches"].values()) for k in COUNTED}
    vtrace = phase_vtrace(dev, states, sync["numbers"])
    vtrace_launches = {k: sum(v[k] for v in vtrace["launches"].values()) for k in COUNTED}
    overlap = phase_overlap(dev, train, step)
    overlap_launches = {k: sum(v[k] for v in overlap["launches"].values()) for k in COUNTED}
    games = phase_games(dev)
    games_launches = {k: sum(v[k] for v in games["launches"].values()) for k in COUNTED}
    trace = phase_trace(dev, states)
    trace_launches = {k: sum(v[k] for v in trace["launches"].values()) for k in COUNTED}
    for name, got in (("vtrace", vtrace_launches), ("overlap", overlap_launches),
                      ("games", games_launches), ("trace", trace_launches)):
        if not all(got.values()):
            raise AssertionError(f"[{name}] a kernel of the path never launched: {got}")

    path = [r for r in rows if r["block"] != "block0_uint8"]
    fwd_by_path = {"serve": serve_launches, "play": play_launches,
                   "train": train_launches["conv_block_fwd"], "resume": resume_fwd,
                   "sync": sync_launches["conv_block_fwd"],
                   "vtrace": vtrace_launches["conv_block_fwd"],
                   "overlap": overlap_launches["conv_block_fwd"],
                   "games": games_launches["conv_block_fwd"],
                   "trace": trace_launches["conv_block_fwd"]}
    bwd_by_path = {k: {"train": train_launches[k], "resume": resume["launches"]["train"][k],
                       "sync": sync_launches[k], "vtrace": vtrace_launches[k],
                       "overlap": overlap_launches[k], "games": games_launches[k],
                       "trace": trace_launches[k]}
                   for k in COUNTED if k != "conv_block_fwd"}
    fwd_ms_at = {nb: {k: sum(r[k] for r in rs if r["block"] != "block0_uint8")
                      for k in ("ms", "plain_ms", "library_ms")}
                 for nb, rs in ((150, vtrace["fwd_rows"]), (1024, rows_by_b[1024]),
                                (2688, overlap["fwd_rows"]), (4096, rows_by_b[4096]))}
    vjp_ms_at = {nb: {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms")}
                 for nb, rows in ((150, vtrace["vjp_rows"]), (2688, overlap["vjp_rows"]),
                                  (4096, games["vjp_rows"]))}
    bwd_src = "distributed_ba3c_tpu_torch/csrc/conv_block_bwd.cu"
    kernels = [{
        "name": "conv_block_fwd",
        "route": "cuda",
        "source": "distributed_ba3c_tpu_torch/csrc/conv_block.cu",
        "sources": ["distributed_ba3c_tpu_torch/csrc/conv_block.cu",
                    "distributed_ba3c_tpu_torch/csrc/conv_block.cuh"],
        "replaces": "distributed_ba3c_tpu/ops/pallas_conv.py:252",
        "launches": sum(fwd_by_path.values()),
        "launches_by_path": fwd_by_path,
        "max_abs_err": kernel_err,
        "ms": sum(r["ms"] for r in path),
        "plain_ms": sum(r["plain_ms"] for r in path),
        **summed_bound(path),
        "library_ms": sum(r["library_ms"] for r in path),
        "shapes": "the four blocks of one BA3CNet forward at B=256 (sums); per_block below",
        "per_block": rows,
        f"per_block_b{TRAIN_B}": rows_by_b[TRAIN_B],
        "ms_model_path_by_batch": fwd_ms_at,
        "parity_batches": list(KERNEL_BATCHES),
    }, {
        "name": "conv_block_vjp",
        "route": "cuda",
        "source": bwd_src,
        "sources": [bwd_src, "distributed_ba3c_tpu_torch/csrc/conv_block.cuh",
                    "distributed_ba3c_tpu_torch/csrc/conv_block.cu",
                    "distributed_ba3c_tpu_torch/ops/conv_block.py"],
        "replaces": "distributed_ba3c_tpu/ops/pallas_conv.py:335",
        "launches": sum(bwd_by_path["conv_block_vjp"].values()),
        "launches_by_path": bwd_by_path["conv_block_vjp"],
        "max_abs_err": max(r["max_abs_err"] for r in vjp_rows),
        "ms": sum(r["ms"] for r in vjp_rows),
        "plain_ms": sum(r["plain_ms"] for r in vjp_rows),
        **summed_bound(vjp_rows),
        "library_ms": sum(r["library_ms"] for r in vjp_rows),
        "shapes": ("forward (conv_block_fwd) + backward (route, dgrad, wgrad) of the four "
                   f"blocks of one learner chunk at B={TRAIN_B} under block_rules=xla (sums); "
                   "per_block below"),
        "per_block": vjp_rows,
        "pallas_rules_ms": sum(r["ms"] for r in other),
        "ms_by_batch": vjp_ms_at,
        "per_block_b150": vtrace["vjp_rows"],
        "per_block_b2688": overlap["vjp_rows"],
        "per_block_b4096": games["vjp_rows"],
        "parity_batches": list(BWD_BATCHES),
    }]
    for name in ("route", "dgrad", "wgrad"):
        parts = [r["bwd_kernels"][name] for r in vjp_rows if name in r["bwd_kernels"]]
        lib = [p["library_ms"] for p in parts]
        dev_ms = [p["device_ms"] for p in parts]
        lib_dev = [p["library_device_ms"] for p in parts]
        kernels.append({
            "name": f"conv_block_{name}",
            "route": "cuda",
            "source": bwd_src,
            "replaces": "distributed_ba3c_tpu/ops/pallas_conv.py:351",
            "launches": sum(bwd_by_path[f"conv_block_{name}"].values()),
            "launches_by_path": bwd_by_path[f"conv_block_{name}"],
            "max_abs_err": bwd_err[name],
            "ms": sum(p["ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            **summed_bound(parts),
            "library_ms": None if None in lib else sum(lib),
            "device_ms": None if None in dev_ms else sum(dev_ms),
            "library_device_ms": None if None in lib_dev else sum(lib_dev),
            "shapes": (f"the {len(parts)} blocks of one learner chunk's backward at "
                       f"B={TRAIN_B} (sums; per block in conv_block_vjp's per_block; ms "
                       "CUDA events around the wrapper, device_ms the profiler's kernel "
                       "time)"),
        })
    log(json.dumps({"serving": serve, "model_forward_ms": fwd, "play_launches": play_launches,
                    "train": {"cli": train, "step": step, "grad_rel_l2": grad["rel_l2"],
                              "learner_peak_bytes": grad["peak_bytes"]},
                    "resume": resume, "sync": sync,
                    "vtrace": {k: v for k, v in vtrace.items() if k not in ("vjp_rows", "fwd_rows")},
                    "overlap": {k: v for k, v in overlap.items()
                                if k not in ("vjp_rows", "fwd_rows")},
                    "games": {k: v for k, v in games.items() if k != "vjp_rows"},
                    "trace": trace, "packages": probe}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
