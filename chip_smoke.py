#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``--parity`` only builds the kernels and holds each against its plain
version, forward and backward, the first call to make after a kernel
changes; ``--kernel-times 1,128,256,2560`` also times every block's
forward and backward kernels at those batches and prints them as one JSON
line, to compare two source trees in one call.)

It builds every kernel of the port's paths from ``distributed_ba3c_tpu_torch``'s
sources (``csrc/conv_block.cu``, the forward; ``csrc/conv_block_bwd.cu``, the
backward's route, dgrad and wgrad), holds each against its plain PyTorch
version at the shapes the paths give it (the backward per block on tie and
random inputs at B = 1, 3 and 2560, and twice for bit-equal gradients), then
drives the paths through the entry points a user calls: ``BA3CNet`` at full
width (84x84x4 uint8 frames, convs 32/32/64/64, FC 512, 6 actions, seeded
random weights) on native Pong frames, ``BatchedPredictor`` serving block and
single-row requests, ``python -m distributed_ba3c_tpu_torch --task play``,
and ``--task train --trainer tpu_fused_ba3c --env jax:pong`` (128 envs x 20
steps per update, the learner through the conv-block kernels forward and
backward). Every phase must pass; any failure exits nonzero and prints no
result.

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
KERNEL_BATCHES = (1, 3, B, TRAIN_B)  # B=1 and 3 catch ragged-edge and tail faults
BWD_BATCHES = (1, 3, TRAIN_B)
DZ_MISMATCH = 1e-3  # share of dz elements the route may route otherwise than cuDNN's z
TIMED_BATCHES = (B, TRAIN_B)


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


def phase_bwd_kernels(dev, batches=BWD_BATCHES):
    """Each block's backward at B in ``batches``, on tie and random inputs:
    the conv_block Function's gradients (the route, dgrad and wgrad kernels)
    against the plain block's VJP, dx, dw and db each within REL_TOL of
    max|ref|; each kernel against its plain version on the same inputs; two
    identical backward calls bit-equal. Returns each kernel's largest
    max|d| against its plain version (the route's: in dz)."""
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
        for i, s, plain, x_grad in vjp_cases():
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
                checks = {f"vjp {n}": rel[n] < REL_TOL for n in names}
                dz_off = float((dz != dz_ref).float().mean())
                rel["route db"] = _rel(dbpart.sum(0), dbpart_ref.sum(0))
                worst["route"] = max(worst["route"], _abs(dz, dz_ref))
                checks["route dz"] = dz_off <= DZ_MISMATCH
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
                    + f" dz-mismatch={dz_off:.2e}" + (" ok" if ok else
                    " FAIL " + ",".join(k for k, v in checks.items() if not v)))
                if not ok:
                    raise AssertionError(f"conv_block backward disagrees on block{i} B={nb} {kind}")
                del grads, dz, dz_ref, again, first
    set_launch_counts(saved)  # comparison launches do not count
    return worst


def phase_bwd_times(dev, nb: int) -> dict:
    """Each backward kernel's time per block at batch ``nb`` on random
    inputs: {block: {kernel: ms}}."""
    from distributed_ba3c_tpu_torch.ops.conv_block import (
        conv_block_dgrad,
        conv_block_route,
        conv_block_wgrad,
    )

    saved = launch_counts()
    out = {}
    for i, s, plain, x_grad in vjp_cases():
        x, w, b, gy = bwd_inputs(s, nb, "random", dev, seed=i)
        dz, dbpart = conv_block_route(x, w, b, gy, s, plain)
        ms = {"route": time_ms(lambda: conv_block_route(x, w, b, gy, s, plain), iters=10),
              "wgrad": time_ms(lambda: conv_block_wgrad(x, dz, dbpart, s), iters=10)}
        if x_grad:
            ms["dgrad"] = time_ms(lambda: conv_block_dgrad(dz, w, s), iters=10)
        out[f"block{i}"] = ms
        log(f"[kernel-times] block{i} backward at B={nb}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    set_launch_counts(saved)
    return out


def vjp_cases():
    """(index, spec, plain, x takes a gradient) of each block as the model
    runs it: block 0 on bf16 frames / 255 with flax's rules and no input
    gradient, blocks 1-3 with reference_block's."""
    from distributed_ba3c_tpu_torch.ops.conv_block import (
        ba3c_specs,
        flax_block,
        reference_block,
        supported,
    )

    return [(i, dataclasses.replace(s0, scale_uint8=False),
             reference_block if supported(s0) else flax_block, i > 0)
            for i, s0 in enumerate(ba3c_specs())]


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
    import torch

    from distributed_ba3c_tpu_torch.envs.jaxenv import pong
    from distributed_ba3c_tpu_torch.fused.loop import initial_stack, push_frame, device_draws

    draws = device_draws(pong, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = pong.reset(draws.reset_noise(n_envs, dev))
    stack = initial_stack(pong, state, 4)
    out = []
    for _ in range(steps + 8):
        a = torch.randint(0, 6, (n_envs,), generator=g, device=dev, dtype=torch.int32)
        state, obs, _, done = pong.step(state, a, draws.env_noise(n_envs, dev))
        stack = push_frame(stack, obs, done)
        out.append(stack)
    return torch.cat(out[-steps:])


def phase_vjp(dev, states):
    """The conv_block Function (kernel forward; backward the route, dgrad
    and wgrad kernels) per block at B=2560, as the learner runs it, against
    the plain block under autograd on the same inputs, with the times of
    both and of the library's F.conv2d + relu + F.max_pool2d under
    autograd; then each backward kernel alone against its plain version and
    one library call of the same function (aten.convolution_backward for
    the dgrad and the wgrad; the route has none)."""
    import torch
    import torch.nn.functional as F

    from distributed_ba3c_tpu_torch.ops.conv_block import (
        _conv_input,
        conv_block,
        conv_block_dgrad,
        conv_block_route,
        conv_block_wgrad,
        dgrad_plain,
        route_plain,
        wgrad_plain,
    )

    g = torch.Generator().manual_seed(1)
    x = (states.reshape(TRAIN_B, 84, 84 * 4).to(torch.bfloat16) / 255.0).contiguous()
    rows = []
    saved = launch_counts()
    for i, s, plain, x_grad in vjp_cases():
        w = (torch.randn((s.kh, s.kw, s.Ci, s.Co), generator=g) * 0.1).to(torch.bfloat16).to(dev)
        b = (torch.randn((s.Co,), generator=g) * 0.05).to(torch.bfloat16).to(dev)
        gy = torch.randn((TRAIN_B, s.Ho, s.Wo * s.Co), generator=g).to(torch.bfloat16).to(dev)

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
            x4 = xx.reshape(TRAIN_B, s.H, s.W, s.Ci).permute(0, 3, 1, 2)
            y = F.relu(F.conv2d(F.pad(x4, pad), ww.permute(3, 2, 0, 1), bb))
            y = F.max_pool2d(y, 2) if s.pool else y
            return y.permute(0, 2, 3, 1).reshape(TRAIN_B, s.Ho, s.Wo * s.Co)

        got, ref = run(fn_kernel), run(fn_plain)
        torch.cuda.synchronize()
        errs = [float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)]
        scales = [float(r.float().abs().max()) for r in ref]
        names = ["y"] + (["dx"] if x_grad else []) + ["dw", "db"]
        ok = all(e <= REL_TOL * max(sc, 1e-6) for e, sc in zip(errs, scales))
        log(f"[vjp] block{i} ({plain.__name__} rules) B={TRAIN_B}: "
            + " ".join(f"{n} max|d|={e:.4g} (max|ref| {sc:.4g})" for n, e, sc in zip(names, errs, scales))
            + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"conv_block VJP disagrees with its plain block on block{i}")
        # bf16 bytes: x, w, b and the cotangent read once; y, dw, db (and
        # dx where x takes a gradient) written once. Operations: the
        # forward conv, the weight gradient, and the input gradient where
        # it is computed
        n_bytes = 2 * (x.numel() + w.numel() + b.numel() + gy.numel()
                       + gy.numel() + w.numel() + b.numel() + x.numel() * x_grad)
        n_ops = (2 + x_grad) * TRAIN_B * needed_flops(s)
        row = {
            "block": f"block{i}",
            "rules": plain.__name__,
            "shape": [TRAIN_B, s.H, s.W, s.Ci, s.Co, s.kh, int(s.pool)],
            "max_abs_err": max(errs),
            "max_abs_err_by_output": dict(zip(names, errs)),
            "ms": time_ms(lambda: run(fn_kernel), iters=5, warmup=2),
            "plain_ms": time_ms(lambda: run(fn_plain), iters=5, warmup=2),
            "library_ms": time_ms(lambda: run(fn_library), iters=5, warmup=2),
            **bound(n_bytes, n_ops),
        }
        log(f"[vjp] block{i}: fwd+bwd kernel path {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

        # each backward kernel alone, on this block's inputs
        dz, dbpart = conv_block_route(x, w, b, gy, s, plain)
        Hd, Wd = dz.shape[1:3]
        # the library's inputs, laid out outside the timed call: NCHW views
        # of the channels-last data, x padded SAME and cut to dz's grid
        x_nchw = _conv_input(x, s, torch.bfloat16)[:, :, : Hd + s.kh - 1, : Wd + s.kw - 1]
        x_nchw = x_nchw.contiguous(memory_format=torch.channels_last)
        dz_nchw = dz.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def library_bwd(mask):
            return torch.ops.aten.convolution_backward(
                dz_nchw, x_nchw, w_oihw, [s.Co], [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)

        n_x, n_dz = x.numel() * x.element_size(), dz.numel() * 2
        ops = TRAIN_B * needed_flops(s)
        kern = {
            "route": {
                "ms": time_ms(lambda: conv_block_route(x, w, b, gy, s, plain), iters=5, warmup=2),
                "plain_ms": time_ms(lambda: route_plain(x, w, b, gy, s, plain), iters=5, warmup=2),
                "library_ms": None,
                **bound(n_x + 2 * (w.numel() + b.numel() + gy.numel()) + n_dz, ops),
            },
            "wgrad": {
                "ms": time_ms(lambda: conv_block_wgrad(x, dz, dbpart, s), iters=5, warmup=2),
                "plain_ms": time_ms(lambda: wgrad_plain(x, dz, dbpart, s), iters=5, warmup=2),
                "library_ms": time_ms(lambda: library_bwd([False, True, True]), iters=5, warmup=2),
                **bound(n_x + n_dz + 2 * (w.numel() + b.numel()), ops),
            },
        }
        if x_grad:
            kern["dgrad"] = {
                "ms": time_ms(lambda: conv_block_dgrad(dz, w, s), iters=5, warmup=2),
                "plain_ms": time_ms(lambda: dgrad_plain(dz, w, s), iters=5, warmup=2),
                "library_ms": time_ms(lambda: library_bwd([True, False, False]), iters=5, warmup=2),
                **bound(n_dz + 2 * w.numel() + n_x, ops),
            }
        row["bwd_kernels"] = kern
        log(f"[vjp] block{i} backward kernels at B={TRAIN_B}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, library "
            f"{'-' if v['library_ms'] is None else format(v['library_ms'], '.4f')}, bound "
            f"{v['bound_ms']:.4f} {v['bound_by']}, {100 * v['bound_ms'] / v['ms']:.1f}% of it)"
            for k, v in kern.items()))
        rows.append(row)
        del dz, dbpart, x_nchw, dz_nchw
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


def phase_train_grads(dev, states):
    """One learner chunk (B=2560 Pong states) through BA3CNet(6) at full
    width: the gradients with conv_backend="cuda" (the kernel forward and
    the backward kernels) against conv_backend="torch" (the plain blocks
    under autograd), and each one's peak device memory
    (``max_memory_allocated`` over the chunk, states and nets included)."""
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.fused.loop import learner_grads
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    g = torch.Generator(device=dev).manual_seed(2)
    actions = torch.randint(0, 6, (TRAIN_B,), generator=g, device=dev)
    returns = torch.randn((TRAIN_B,), generator=g, device=dev)
    grads, aux, peak = {}, {}, {}
    for backend in ("cuda", "torch"):
        net = BA3CNet(6, conv_backend=backend, device=dev,
                      generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gs, loss = learner_grads(net, BA3CConfig(), states, actions, returns, 0.01,
                                 grad_chunk_samples=TRAIN_B)
        torch.cuda.synchronize()
        peak[backend] = torch.cuda.max_memory_allocated(dev)
        grads[backend] = {k: gr for (k, _), gr in zip(net.named_parameters(), gs)}
        aux[backend] = float(loss.total)
        del net, gs, loss
    errs = _rel_l2(grads["cuda"], grads["torch"])
    worst = max(errs, key=errs.get)
    log(f"[train] learner chunk B={TRAIN_B} gradients, kernels vs plain blocks: "
        f"worst rel-L2 {errs[worst]:.3e} ({worst}); loss {aux['cuda']:.6f} vs {aux['torch']:.6f}; "
        f"peak memory {peak['cuda'] / 2**30:.3f} GiB vs {peak['torch'] / 2**30:.3f} GiB")
    if not all(torch.isfinite(v).all() for v in grads["cuda"].values()):
        raise AssertionError("learner gradients on the card are not finite")
    if errs[worst] >= GRAD_REL_L2:
        raise AssertionError(f"learner gradients disagree: {errs}")
    return {"rel_l2": errs, "peak_bytes": peak}


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


def phase_train_step(dev):
    """The fused step at the trainer's shape through the API: launches per
    update, a step at learning rate 0 leaves the params equal, a live step
    moves them; and the update's parts timed with CUDA events."""
    import torch

    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.envs.jaxenv import pong
    from distributed_ba3c_tpu_torch.fused.loop import (
        push_frame,
        create_fused_state,
        learner_grads,
        make_fused_step,
    )
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    cfg = BA3CConfig(batch_size=TRAIN_B)
    net = BA3CNet(6, device=dev, generator=torch.Generator().manual_seed(0))
    state = create_fused_state(0, net, cfg, pong, TRAIN_ENVS)
    opt = state.train.optimizer
    step = make_fused_step(net, opt, cfg, pong, TRAIN_T)
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
    log(f"[train] step API: launches per update {per_update}; lr=0 leaves params equal: {same}; "
        f"lr=1e-3 moved {moved}/{len(before)} tensors; metrics finite: {finite}")
    if not (same and moved > 0 and finite):
        raise AssertionError("the fused step's update is wrong")

    # the parts of one update at its shapes
    B = TRAIN_ENVS
    stack = state.obs_stack
    actions = torch.randint(0, 6, (B,), device=dev, dtype=torch.int32)

    def env_step():
        st, obs, _, done = pong.step(state.env_state, actions, state.draws.env_noise(B, dev))
        return push_frame(stack, obs, done)

    flat_states = torch.cat([stack] * TRAIN_T)
    flat_actions = torch.randint(0, 6, (TRAIN_B,), device=dev)
    flat_returns = torch.randn((TRAIN_B,), device=dev)
    grads, _ = learner_grads(net, cfg, flat_states, flat_actions, flat_returns, 0.01)
    opt.set_learning_rate(0.0)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: net(stack), iters=10)
    parts = {
        "rollout_forward_ms": TRAIN_T * fwd_ms,
        "bootstrap_forward_ms": fwd_ms,
        "env_step_ms": TRAIN_T * time_ms(env_step, iters=10),
        "learner_fwd_bwd_ms": time_ms(
            lambda: learner_grads(net, cfg, flat_states, flat_actions, flat_returns, 0.01),
            iters=3, warmup=1),
        "optimizer_ms": time_ms(lambda: opt.step(grads), iters=10),
    }
    saved = launch_counts()
    parts["update_ms"] = time_ms(lambda: step(state, 0.01, 0.0), iters=3, warmup=1)
    set_launch_counts(saved)
    parts["parts_sum_ms"] = sum(v for k, v in parts.items() if k not in ("update_ms",))
    parts["env_steps_per_s"] = TRAIN_B / parts["update_ms"] * 1e3
    log(f"[train] per update (B={B} envs x T={TRAIN_T}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    return {"launches_per_update": per_update, **parts}


#: the launch counts the paths are read by: each kernel wrapper's, and
#: conv_block's backward passes on the card (conv_block_vjp)
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


#: launches per training update: 4 blocks x (T rollout forwards + 1
#: bootstrap + 1 learner chunk); per learner chunk one backward of each
#: block: a route each, a dgrad for blocks 1-3, a wgrad each
PER_UPDATE = {"conv_block_fwd": 4 * (TRAIN_T + 2), "conv_block_vjp": 4,
              "conv_block_route": 4, "conv_block_dgrad": 3, "conv_block_wgrad": 4}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--parity", action="store_true",
                    help="only build the kernels and hold each against its plain "
                         "version (a new kernel's first call); prints no result")
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

    phase_build()
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
    vjp_rows = phase_vjp(dev, train_states)
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

    path = [r for r in rows if r["block"] != "block0_uint8"]
    fwd_by_path = {"serve": serve_launches, "play": play_launches,
                   "train": train_launches["conv_block_fwd"]}
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
        "parity_batches": list(KERNEL_BATCHES),
    }, {
        "name": "conv_block_vjp",
        "route": "cuda",
        "source": bwd_src,
        "sources": [bwd_src, "distributed_ba3c_tpu_torch/csrc/conv_block.cuh",
                    "distributed_ba3c_tpu_torch/csrc/conv_block.cu",
                    "distributed_ba3c_tpu_torch/ops/conv_block.py"],
        "replaces": "distributed_ba3c_tpu/ops/pallas_conv.py:335",
        "launches": train_launches["conv_block_vjp"],
        "launches_by_path": {"train": train_launches["conv_block_vjp"]},
        "max_abs_err": max(r["max_abs_err"] for r in vjp_rows),
        "ms": sum(r["ms"] for r in vjp_rows),
        "plain_ms": sum(r["plain_ms"] for r in vjp_rows),
        **summed_bound(vjp_rows),
        "library_ms": sum(r["library_ms"] for r in vjp_rows),
        "shapes": ("forward (conv_block_fwd) + backward (route, dgrad, wgrad) of the four "
                   f"blocks of one learner chunk at B={TRAIN_B} (sums); per_block below"),
        "per_block": vjp_rows,
        "parity_batches": list(BWD_BATCHES),
    }]
    for name in ("route", "dgrad", "wgrad"):
        parts = [r["bwd_kernels"][name] for r in vjp_rows if name in r["bwd_kernels"]]
        lib = [p["library_ms"] for p in parts]
        kernels.append({
            "name": f"conv_block_{name}",
            "route": "cuda",
            "source": bwd_src,
            "replaces": "distributed_ba3c_tpu/ops/pallas_conv.py:351",
            "launches": train_launches[f"conv_block_{name}"],
            "launches_by_path": {"train": train_launches[f"conv_block_{name}"]},
            "max_abs_err": bwd_err[name],
            "ms": sum(p["ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            **summed_bound(parts),
            "library_ms": None if None in lib else sum(lib),
            "shapes": (f"the {len(parts)} blocks of one learner chunk's backward at "
                       f"B={TRAIN_B} (sums; per block in conv_block_vjp's per_block)"),
        })
    log(json.dumps({"serving": serve, "model_forward_ms": fwd, "play_launches": play_launches,
                    "train": {"cli": train, "step": step, "grad_rel_l2": grad["rel_l2"],
                              "learner_peak_bytes": grad["peak_bytes"]}}))
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
