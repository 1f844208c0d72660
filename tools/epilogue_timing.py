"""Times of the quantizing epilogues (B4, B5, B6, B9) on one H100, at the
shapes chip_smoke.py's phase 3 checks them at, for the port in a given
checkout.

The measuring code is this tree's chip_smoke.py; the package and its CUDA
kernels come from ``--root`` (this checkout by default), so that two commits
can be timed in one call on one card, in turns (``git archive <commit> |
tar -x -C scratch/other``, a directory that .gitignore lists):

    python tools/epilogue_timing.py [--root DIR] [--label NAME] [--sweep] [--b6]
                                    [--b6-variants]

Each reading is one ``READING {json}`` line: the kernel, its (M, H) and
dtype, the CUDA-event time of one call over 100 back-to-back calls (three
times), and torch.profiler's device time a call, split into the epilogue
kernel (``quant``) and any other kernel the wrapper launches (``other``: a
weight copy, for instance). ``--sweep`` (this checkout's streaming B4 / B9
only) also times the kernel at the W8A8 paths' shapes over tile plans, R
rows a tile by S stages (``plan``; ``chosen`` marks ``tile_plan``'s), by the
CUDA-event time of one launch over 50 through the C interface.

``--b6`` reads B6 (``row_quant``, ``row_absmax``, ``row_quant(x, amax)``) in
each mode at every shape of chip_smoke.row_quant_shapes, through the wrappers
of the ``--root`` checkout (so the kernel it had before can be read too):
events over 100 calls, the profiler's device time a call (a session a
case), the wrapper's host microseconds a call while the card is busy
(chip_smoke.host_us, 1000 calls), the bound, vector_norm(x, inf)'s events
and device time beside the absmax mode, and whether the outputs equal the plain versions'
bit for bit; then (this checkout only) the host cost of each step of the
wrapper at a tp-2 rank's qwen o_proj rows. ``--b6-variants`` (this checkout
only) reads other plans through the C interface at every shape the warp
form takes: the block form, the branch a chunk in place of a whole-lane
instantiation, and other rows a tile and stages.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
ap.add_argument("--label", default="tree")
ap.add_argument("--sweep", action="store_true")
ap.add_argument("--b6", action="store_true")
ap.add_argument("--b6-variants", action="store_true")
args = ap.parse_args()
ROOT = os.path.abspath(args.root)
sys.path.insert(0, ROOT)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

import torch  # noqa: E402

qe = cs.qe
assert qe.__file__.startswith(ROOT), qe.__file__


def emit(**kw):
    print("READING " + json.dumps({"label": args.label, **kw}), flush=True)


def cases(gen):
    bf = torch.bfloat16
    vcfg, dcfg, qcfg = cs.phi35_vision_config().vision, cs.phi35_vision_config().decoder, \
        cs.qwen25_vl_7b_config().text

    def rows(M, n, mul=1.0):
        return cs._zero_rows(torch.randn(M, n, generator=gen, device="cuda", dtype=bf).mul_(mul))

    def weight(H, scale, shift):
        return (shift + scale * torch.randn(H, generator=gen, device="cuda")).to(bf)

    for M in (cs.CLIP_M2, cs.CLIP_M8):
        H, eps = vcfg.hidden_size, vcfg.layer_norm_eps
        x, w, b = rows(M, H, 2.0), weight(H, 0.1, 1.0), weight(H, 0.1, 0.0)
        yield "ln_quant", (M, H), lambda: qe.ln_quant(x, w, b, eps)
    for M, c in ((cs.W8A8_M, dcfg), (cs.QWEN_M, qcfg)):
        H, I, eps = c.hidden_size, c.intermediate_size, c.rms_norm_eps
        x, w = rows(M, H), weight(H, 0.1, 1.0)
        yield "rms_quant", (M, H), lambda: qe.rms_quant(x, w, eps)
        yield "row_quant", (M, H), lambda: qe.row_quant(x)
        gu = rows(M, 2 * I, 2.0)
        yield "silu_mul_quant", (M, 2 * I), lambda: qe.silu_mul_quant(gu)
        del gu


cs.phase_device()
cs.cuda_lib.load()
for name, shape, run in ([] if args.b6 or args.b6_variants
                         else cases(torch.Generator(device="cuda").manual_seed(1))):
    events = [cs.time_ms(run, iters=100) for _ in range(3)]
    split = cs._device_split(run, ["quant"], reps=20)
    emit(kernel=name, shape=list(shape), dtype="bf16", events_ms=events,
         device_ms={k: round(v, 6) for k, v in split.items()})
    torch.cuda.empty_cache()


def sweep(gen):
    lib, st = cs.cuda_lib.load(), torch.cuda.current_stream().cuda_stream
    for kind, M, H in (("ln_quant", cs.CLIP_M8, 1024), ("rms_quant", cs.W8A8_M, 3072),
                       ("rms_quant", cs.QWEN_M, 3584)):
        x = cs._zero_rows(torch.randn(M, H, generator=gen, device="cuda").bfloat16())
        w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).bfloat16()
        b = (0.1 * torch.randn(H, generator=gen, device="cuda")).bfloat16()
        codes = torch.empty(M, H, dtype=torch.int8, device="cuda")
        amax = torch.empty(M, 1, device="cuda")
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), codes.data_ptr(), amax.data_ptr())
        rows_max = qe.NQ_ROWS_MAX if H <= 2048 else qe.NQ_ROWS_MAX_WIDE
        for R in range(1, rows_max + 1):
            for S in (2, 3, 4):
                ln = kind == "ln_quant"
                smem = qe.NQ_HEAD + S * R * H * 2 + 2 * R * H + 4 * H * (2 if ln else 1)
                if smem > 232448:  # an H100 block's most shared memory
                    continue
                if ln:
                    run = lambda: lib.lrt_ln_quant(*ptrs, M, H, 1e-5, 1, 1, 1, R, S, st)  # noqa
                else:
                    run = lambda: lib.lrt_rms_quant(  # noqa: E731
                        ptrs[0], ptrs[1], *ptrs[3:], M, H, 1e-5, 1, 1, R, S, st)
                if run() != 0:
                    raise RuntimeError(f"{kind} R={R} S={S}: launch failed")
                emit(kernel=kind, shape=[M, H], dtype="bf16", plan=[R, S], smem=smem,
                     chosen=qe.tile_plan(H, 2, ln, M)[:2] == (R, S),
                     events_ms=cs.time_ms(run, iters=50, warmup=3))
        del x, codes
        torch.cuda.empty_cache()


def b6_shapes():
    return cs.row_quant_shapes(cs.phi35_vision_config(), cs.qwen25_vl_7b_config(),
                               cs.LlavaNextConfig())


def b6(gen):
    """B6 through the wrappers of --root, each mode at every shape."""
    cases = []
    for what, M, H in b6_shapes():
        x = cs._zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=torch.bfloat16))
        raw = qe.row_absmax_plain(x)
        given = raw * (1 + torch.rand(M, 1, generator=gen, device="cuda"))
        for mode in cs.B6_MODES:
            run = cs._b6_call(mode, x, given)
            got = run()
            ref = {"whole": lambda: qe.row_quant_plain(x), "absmax": lambda: raw,
                   "given": lambda: qe.row_quant_plain(x, given)}[mode]()
            torch.cuda.synchronize()
            exact = (torch.equal(got, ref) if mode == "absmax" else
                     torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
            del got, ref
            nbytes, nops = cs._b6_bytes_ops(mode, M, H)
            lib = cs.time_ms(lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1),
                             iters=100) if mode == "absmax" else None
            host, busy = cs.host_us(run, calls=1000, sleep_cycles=200_000_000)
            extra = {} if mode != "absmax" else dict(
                lib_run=lambda x=x: torch.linalg.vector_norm(x, float("inf"), dim=-1))
            cases.append(dict(what=what, shape=[M, H], mode=mode, run=run, exact=exact, **extra,
                              events_ms=[cs.time_ms(run, iters=100) for _ in range(2)],
                              bound_ms=cs.bound_ms(nops, nbytes, cs.PEAK_FP32_FLOPS)[0],
                              library_ms=lib, host_us=host, card_busy=busy))
        torch.cuda.synchronize()
    libs = [c for c in cases if c["mode"] == "absmax"]
    lib_devs = cs.device_ms_each([c.pop("lib_run") for c in libs])
    for c, dev in zip(cases, cs.device_ms_each([c["run"] for c in cases], key="quant_kernel")):
        c.pop("run")
        emit(kernel="row_quant", dtype="bf16", device_ms=dev, **c)
    for c, dev in zip(libs, lib_devs):
        emit(kernel="vector_norm", dtype="bf16", what=c["what"], shape=c["shape"], device_ms=dev)
    torch.cuda.empty_cache()


def b6_host_steps(gen):
    """The host cost of each step of this checkout's B6 wrapper, at a tp-2
    rank's qwen o_proj rows (14336, 1792) bf16, microseconds a call."""
    M, H = cs.QWEN_M, 1792
    x = torch.randn(M, H, generator=gen, device="cuda", dtype=torch.bfloat16)
    amax = qe.row_absmax_plain(x)
    dev = x.get_device()
    plan, blocks = qe._row_launch(dev, H, True, "absmax")
    fn, st = cs.cuda_lib.load().lrt_row_quant, torch._C._cuda_getCurrentRawStream(dev)
    out = torch.empty(M, 1, device="cuda")
    grid = min(-(-M // plan.rows), blocks)
    launch = (plan.form, plan.nv, plan.rows, plan.stages, plan.keep, grid, st)
    steps = {
        "row_absmax (the wrapper)": lambda: qe.row_absmax(x),
        "row_quant (the wrapper)": lambda: qe.row_quant(x),
        "row_quant given (the wrapper)": lambda: qe.row_quant(x, amax),
        "checks (_rows)": lambda: qe._rows("row_quant", x, H),
        "given amax check (_given)": lambda: qe._given("row_quant", amax, x, M),
        "plan lookup (_row_launch)": lambda: qe._row_launch(dev, H, True, "absmax"),
        "torch.empty_like int8 codes": lambda: torch.empty_like(x, dtype=torch.int8),
        "x.new_empty amax": lambda: x.new_empty(x.shape[:-1] + (1,), dtype=torch.float32),
        "torch.empty amax, device index": lambda: torch.empty(
            (M, 1), dtype=torch.float32, device=dev),
        "torch.empty x2 (the earlier wrapper)": lambda: (
            torch.empty(M, H, dtype=torch.int8, device=x.device),
            torch.empty(M, 1, dtype=torch.float32, device=x.device)),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "torch.cuda.current_stream().cuda_stream": lambda:
            torch.cuda.current_stream().cuda_stream,
        "ctypes call, M = 0 (no launch)": lambda: fn(
            x.data_ptr(), None, out.data_ptr(), None, 0, H, 1, *launch),
        "ctypes call with the launch (absmax)": lambda: fn(
            x.data_ptr(), None, out.data_ptr(), None, M, H, 1, *launch),
        "counting (_count)": lambda: qe._count(qe.TP_LAUNCHES, "row_absmax", H),
    }
    for name, run in steps.items():
        host, busy = cs.host_us(run, calls=1000, sleep_cycles=200_000_000)
        emit(kernel="row_quant host", step=name, shape=[M, H], host_us=host, card_busy=busy)


def b6_variants(gen):
    """Other plans through the C interface, each mode, at every shape the
    warp form takes: the block form, the branch a chunk in place of a
    whole-lane instantiation, and other rows a tile and stages."""
    fn, st = cs.cuda_lib.load().lrt_row_quant, torch._C._cuda_getCurrentRawStream(0)
    lib = cs.cuda_lib.load()
    cases = []
    for what, M, H in b6_shapes():
        if qe.row_plan(H, 2, "whole").form:
            continue
        x = cs._zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=torch.bfloat16))
        raw = qe.row_absmax_plain(x)
        given = raw * (1 + torch.rand(M, 1, generator=gen, device="cuda"))
        codes = torch.empty(M, H, dtype=torch.int8, device="cuda")
        amax = torch.empty(M, 1, device="cuda")
        for mode in cs.B6_MODES:
            chosen = qe.row_plan(H, 2, mode)
            ref = (raw if mode == "absmax" else
                   qe.row_quant_plain(x, given if mode == "given" else None))
            keep = int(mode == "whole")
            plans = [(chosen, "chosen"), (qe.RowPlan(1, 0, 1, 1, keep, keep * H * 2), "block form")]
            if chosen.nv in qe.ROW_FULL_CHUNKS:
                nv = next(n for n in qe.NQ_CHUNKS_PER_LANE if n > chosen.nv)
                plans.append((chosen._replace(nv=nv), "branch a chunk"))
            plans += [(chosen._replace(rows=R, stages=S, smem=qe.NQ_HEAD + S * R * H * 2),
                       f"warp R{R} S{S}")
                      for R in ((4, 7) if chosen.nv <= 8 else (2, 4)) for S in (2, 3)
                      if (R, S) != (chosen.rows, chosen.stages)]
            for p, tag in plans:
                if p.form:
                    grid, blocks = M, None
                else:
                    blocks = lib.lrt_row_quant_blocks(1, p.nv, H, p.rows, p.stages)
                    grid = min(-(-M // p.rows), blocks)
                args = (x.data_ptr(), None if mode == "absmax" else codes.data_ptr(),
                        amax.data_ptr(), given.data_ptr() if mode == "given" else None, M, H, 1,
                        p.form, p.nv, p.rows, p.stages, p.keep, max(1, grid), st)
                if (blocks is not None and blocks < 1) or fn(*args) != 0:
                    emit(kernel="row_quant variant", what=what, shape=[M, H], mode=mode,
                         plan=list(p), tag=tag, error=blocks)
                    continue
                torch.cuda.synchronize()
                exact = (torch.equal(amax, ref) if mode == "absmax" else
                         torch.equal(codes, ref[0]) and torch.equal(amax, ref[1]))
                run = lambda a=args: fn(*a)  # noqa: E731
                cases.append(dict(what=what, shape=[M, H], mode=mode, plan=list(p), tag=tag,
                                  blocks=blocks, exact=exact,
                                  events_ms=cs.time_ms(run, iters=100), run=run,
                                  hold=(x, given, codes, amax)))
    for c, dev in zip(cases, cs.device_ms_each([c["run"] for c in cases], key="quant_kernel")):
        c.pop("run")
        c.pop("hold")
        emit(kernel="row_quant variant", device_ms=dev, **c)


if args.sweep:
    sweep(torch.Generator(device="cuda").manual_seed(2))
if args.b6:
    b6(torch.Generator(device="cuda").manual_seed(3))
    if hasattr(qe, "row_plan"):
        b6_host_steps(torch.Generator(device="cuda").manual_seed(4))
if args.b6_variants:
    b6_variants(torch.Generator(device="cuda").manual_seed(5))
emit(kernel="done")
