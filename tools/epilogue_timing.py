"""Times of the quantizing epilogues (B4, B5, B6, B9) on one H100, at the
shapes chip_smoke.py's phase 3 checks them at, for the port in a given
checkout.

The measuring code is this tree's chip_smoke.py; the package and its CUDA
kernels come from ``--root`` (this checkout by default), so that two commits
can be timed in one call on one card, in turns (``git archive <commit> |
tar -x -C scratch/other``, a directory that .gitignore lists):

    python tools/epilogue_timing.py [--root DIR] [--label NAME] [--sweep]

Each reading is one ``READING {json}`` line: the kernel, its (M, H) and
dtype, the CUDA-event time of one call over 100 back-to-back calls (three
times), and torch.profiler's device time a call, split into the epilogue
kernel (``quant``) and any other kernel the wrapper launches (``other``: a
weight copy, for instance). ``--sweep`` (this checkout's streaming B4 / B9
only) also times the kernel at the W8A8 paths' shapes over tile plans, R
rows a tile by S stages (``plan``; ``chosen`` marks ``tile_plan``'s), by the
CUDA-event time of one launch over 50 through the C interface.
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
for name, shape, run in cases(torch.Generator(device="cuda").manual_seed(1)):
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


if args.sweep:
    sweep(torch.Generator(device="cuda").manual_seed(2))
emit(kernel="done")
