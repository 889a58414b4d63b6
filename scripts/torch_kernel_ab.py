"""Time the port's bf16 kernels of two checkouts on one CUDA card: kernel 1
(RMSNorm), kernel 2 (the flash forward), kernels 3 and 4 (the flash
backward's dk/dv and dq), kernels 5 and 6 (dense flash-decode over bf16
and int8 caches) and kernel 7 (paged flash-decode, over bf16 and int8
pools), at the dense widths and at MLA's 576.

    python3 scripts/torch_kernel_ab.py --parent DIR [--seed 0]
        [--only rms,fwd,bwd,decode,dense-int8,paged,mla,generate]
        [--also NAME=DIR ...]

DIR is a checkout of an earlier commit of this repository (for example
unpacked with `git archive` into a directory that .gitignore lists). Each
checkout's kernel library is built from its own sources into its own
`build/` directory, both are loaded side by side and called through the
same C entry points (`shellac_rms_norm`, `shellac_flash_attention`,
`shellac_flash_attention_bwd_dkdv`, `shellac_flash_attention_bwd_dq`,
`shellac_decode_attention`, `shellac_decode_attention_int8`,
`shellac_paged_decode_attention`,
`shellac_paged_decode_attention_int8`) on the same inputs, at the shapes the port's
main paths give each kernel on shellac-1b (H 16, Hkv 8, D 128, d_model
2048):
  - rms: train 12288 x 2048, prefill 4096 x 2048, serve's largest
    admission 1024 x 2048, decode's 8 and 16 rows; the q/k norms' 65536 x
    128; MLA's kv_a_norm at 512 (serve's 16 rows, prefill's 4096) and
    GPT-OSS-20B's width 2880 (the same rows); beside
    torch.nn.functional.rms_norm;
  - fwd (causal): the train step (6 x 2048, with lse), generate's prefill
    (8 x 512) and serve's B = 1 admissions (S 64, 256 and 1024); beside
    scaled_dot_product_attention;
  - bwd (causal): the train step (6 x 2048), B = 1 at S 2048, and 8 x 512;
    and MLA's training step on shellac-mla-2b (6 x 2048, H = Hkv = 16, q
    and k 192 wide, v and dO 128 wide padded to 192); beside the backward
    call of scaled_dot_product_attention, which computes dq, dk and dv
    together (timed eagerly, since autograd is not captured);
  - decode (s 1, L 2048): generate's ragged step (B 8, lengths 129-577 as
    chip_smoke.py draws them), every slot live to 2048 (B 8), and B 16
    ragged over the whole cache; and generate's step at GPT-OSS-20B's
    heads (64 q over 8 kv heads of 64); beside masked
    scaled_dot_product_attention;
  - dense-int8: the same three steps over an int8 cache with fp32 scales
    (kernel 6); beside the nearest library route, two calls: a
    dequantize of k and v and masked scaled_dot_product_attention;
  - paged (s 1, 16 slots, a 2048-position table): serve's ragged lengths
    (64-1152, as chip_smoke.py draws them) and every slot live to 2048,
    each over a bf16 pool of 16-token blocks and an int8 pool of 64-token
    blocks (fp32 scales) in shuffled pages, and serve's lengths at
    GPT-OSS-20B's heads over bf16 blocks of 16; beside the nearest library
    route, several calls: a gather of the pages and masked
    scaled_dot_product_attention (bf16), with a dequantize between them
    (int8);
  - mla (D 576, s 1, one latent row a token as k and v, L 2048): the
    dense cache at generate's step (B 8, lengths 129-577) with 16 q heads
    (shellac-mla-2b, DeepSeek-V2-Lite), the same over an int8 latent, and
    with DeepSeek-V2/V3's 128 heads; serve's 16 slots over a bf16 pool of
    16-token blocks and an int8 pool of 64-token blocks; every slot live
    to 2048 (dense B 8, the bf16 pool at 16 slots); beside masked
    scaled_dot_product_attention over the latent as k and v (after a
    gather, a dequantize or both, as several calls);
  - generate: shellac-1b (random bf16 weights from --seed) generates
    greedily from chip_smoke.py's 8 prompts for 64 tokens, once on each
    side's kernels; prints whether the tokens agree and, for a row where
    they part, the step, the parent's top-2 logit margin there and the
    largest logit difference between the two sides at that step (both
    sides saw the same tokens up to it).
`--also` adds checkouts (a design variant of this tree, say) timed beside
the two in the same way. Each shape is timed by CUDA-graph replay (device
time) and by eager calls back to back in the order parent, this tree
(then any `--also`), and back again, each call
writing a preallocated output of its input set. Where the library call
allocates its output instead (F.rms_norm), this tree's kernel is also
timed allocating, as chip_smoke.py times both. Prints
the card's name and power limit, then one JSON line a shape and pass.
Exits non-zero without a card, or if either side disagrees with the plain
versions (`rms_norm_ref`, `flash_forward_ref`, `flash_bwd_dkdv_ref`,
`flash_bwd_dq_ref`, `_decode_ref`, `_paged_decode_ref`) beyond the bf16 tolerance (2e-2 +
2e-2 |ref|; for the gradients 2e-2 max|ref| + 2e-2 |ref|).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PEAK_BYTES_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_BF16_S = 989e12
FWD_SHAPES = {  # name: (B, S, with lse)
    "train_6x2048_lse": (6, 2048, True),
    "generate_8x512": (8, 512, False),
    "serve_1x1024": (1, 1024, False),
    "serve_1x256": (1, 256, False),
    "serve_1x64": (1, 64, False),
}
BWD_SHAPES = {  # name: (B, S, H, Hkv, D, v's live width)
    "train_6x2048": (6, 2048, 16, 8, 128, 128),
    "b1_2048": (1, 2048, 16, 8, 128, 128),
    "b8_512": (8, 512, 16, 8, 128, 128),
    "mla_6x2048_d192": (6, 2048, 16, 16, 192, 128),
}
RMS_SHAPES = {  # name: (rows, d)
    "train_12288x2048": (12288, 2048),
    "prefill_4096x2048": (4096, 2048),
    "serve_prefill_1024x2048": (1024, 2048),
    "generate_decode_8x2048": (8, 2048),
    "serve_decode_16x2048": (16, 2048),
    "qk_norm_65536x128": (65536, 128),
    "mla_serve_decode_16x512": (16, 512),
    "mla_prefill_4096x512": (4096, 512),
    "gptoss_serve_decode_16x2880": (16, 2880),
    "gptoss_prefill_4096x2880": (4096, 2880),
}
# shellac-1b's heads (16 q over 8 kv heads of 128) and GPT-OSS-20B's.
HEADS_1B, HEADS_GPTOSS = (16, 8, 128), (64, 8, 64)
DECODE_SHAPES = {  # name: (B, lengths: "generate" | "full" | "ragged",
    #                  (H, Hkv, D))
    "generate_8_ragged": (8, "generate", HEADS_1B),
    "full_live_8x2048": (8, "full", HEADS_1B),
    "b16_ragged": (16, "ragged", HEADS_1B),
    "gptoss_generate_8_ragged_d64": (8, "generate", HEADS_GPTOSS),
}
PAGED_SHAPES = {  # name: (pool "bf16" | "int8", block size, lengths,
    #                  (H, Hkv, D))
    "serve_ragged_bs16": ("bf16", 16, "serve", HEADS_1B),
    "serve_ragged_int8_bs64": ("int8", 64, "serve", HEADS_1B),
    "full_live_bs16": ("bf16", 16, "full", HEADS_1B),
    "full_live_int8_bs64": ("int8", 64, "full", HEADS_1B),
    "gptoss_serve_ragged_bs16_d64": ("bf16", 16, "serve", HEADS_GPTOSS),
}
MLA_SHAPES = {  # name: (cache "dense" | "paged", "bf16" | "int8", slots,
    #                q heads, block size, lengths "step" | "full")
    "dense_b8_generate": ("dense", "bf16", 8, 16, None, "step"),
    "dense_b8_generate_int8": ("dense", "int8", 8, 16, None, "step"),
    "dense_b8_generate_128_heads": ("dense", "bf16", 8, 128, None, "step"),
    "paged_16_serve_bs16": ("paged", "bf16", 16, 16, 16, "step"),
    "paged_16_serve_int8_bs64": ("paged", "int8", 16, 16, 64, "step"),
    "dense_b8_full_live": ("dense", "bf16", 8, 16, None, "full"),
    "paged_16_full_live_bs16": ("paged", "bf16", 16, 16, 16, "full"),
}
H, HKV, D = HEADS_1B  # the flash forward's shapes
SLOTS = 16
MLA_D = 576
L = 2048
BF16 = 1  # dtype code of csrc/common.cuh


def load_build(checkout: Path, name: str):
    path = checkout / "shellac_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: cudaError_t {err}")


def call_fwd(lib, q, k, v, out, lse):
    b, s, h, d = q.shape
    _raise("shellac_flash_attention", lib.shellac_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h,
        k.shape[2], d, d ** -0.5, 1, -1, 0.0, BF16, _stream()))


def call_dkdv(lib, q, k, v, do, lse, dl, dk, dv):
    b, s, h, d = q.shape
    _raise("shellac_flash_attention_bwd_dkdv",
           lib.shellac_flash_attention_bwd_dkdv(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), dl.data_ptr(), None, dk.data_ptr(),
               dv.data_ptr(), b, s, h, k.shape[2], d, d ** -0.5, 1, -1, 0.0,
               BF16, _stream()))


def call_dq(lib, q, k, v, do, lse, dl, dq):
    b, s, h, d = q.shape
    _raise("shellac_flash_attention_bwd_dq",
           lib.shellac_flash_attention_bwd_dq(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), dl.data_ptr(), None, dq.data_ptr(), b, s, h,
               k.shape[2], d, d ** -0.5, 1, -1, 0.0, BF16, _stream()))


def graph_ms(fn, sets, iters):
    """Mean device ms per call: `iters` calls cycling through `sets`,
    captured in one CUDA graph, replayed, timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def eager_ms(fn, sets, iters):
    """Mean ms per call of `iters` eager calls back to back, by CUDA
    events: the host's cost per call wherever it outruns the device."""
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def n_copies(first, nbytes=None):
    """Input sets to cycle through so that one pass exceeds the L2:
    `nbytes` a call reads (by default every byte of `first`)."""
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in first
                     if isinstance(t, torch.Tensor))
    return min(16, max(1, -(-(256 << 20) // nbytes)))


def bound(flops, nbytes):
    tf, tb = flops / PEAK_BF16_S, nbytes / PEAK_BYTES_S
    return max(tf, tb) * 1e3, "operations" if tf >= tb else "bytes"


def close(out, ref, scaled=False):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    atol = 2e-2 * (ref.abs().max() if scaled else 1.0)
    return {"max_abs_err": err.max().item(),
            "ok": bool(torch.isfinite(out).all()
                       and (err <= atol + 2e-2 * ref.abs()).all())}


def ab(libs, fn_of, sets, iters):
    """Graph and eager ms of each side, in the order of `libs` and back
    (parent, new, new, parent)."""
    times = {who: [] for who in libs}
    eager = {who: [] for who in libs}
    for who in list(libs) + list(reversed(libs)):
        fn = fn_of(libs[who])
        times[who].append(graph_ms(fn, sets, iters))
        eager[who].append(eager_ms(fn, sets, iters))
    return times, eager


def call_rms(lib, x, scale, out):
    rows, d = x.shape
    _raise("shellac_rms_norm", lib.shellac_rms_norm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, 1e-5, BF16,
        _stream()))


def run_rms(libs, gen, dev, card):
    from shellac_tpu_torch.ops.norms import rms_norm_ref

    bf = torch.bfloat16
    ok = True
    for name, (rows, d) in RMS_SHAPES.items():
        def make():
            x = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            sc = 0.1 * torch.randn((d,), generator=gen, device=dev)
            return x, sc, torch.empty_like(x), (1.0 + sc).to(bf)

        first = make()
        sets = [first] + [make() for _ in range(n_copies(first[:3]) - 1)]
        x, sc = first[:2]
        ref = rms_norm_ref(x, sc, 1e-5)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(x)
            call_rms(lib, x, sc, out)
            torch.cuda.synchronize()
            errs[who] = close(out, ref)
            ok = ok and errs[who]["ok"]
        iters = 200
        times, eager = ab(libs, lambda lib: lambda x, s, o, w: call_rms(
            lib, x, s, o), sets, iters)
        # F.rms_norm allocates its output, which inside one captured
        # graph reuses one block (L2-resident at these sizes); the
        # kernel is timed that way too beside it.
        library = graph_ms(lambda x, s, o, w: F.rms_norm(
            x, (d,), w, 1e-5), sets, iters)
        new_alloc = graph_ms(lambda x, s, o, w: call_rms(
            libs["new"], x, s, torch.empty_like(x)), sets, iters)
        nbytes = 2 * rows * d * 2 + d * 4
        bms, by = bound(4 * rows * d, nbytes)
        new_ms = min(times["new"])
        print(json.dumps({
            "pass": "rms", "shape": name, "rows": rows, "d": d,
            "ms": times, "eager_ms": eager, "f_rms_norm_ms": library,
            "new_allocating_ms": new_alloc,
            "bound_ms": bms, "bound_by": by, "roofline_share": bms / new_ms,
            "parent_over_new": min(times["parent"]) / new_ms,
            "new_allocating_over_library": new_alloc / library,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def decode_lengths(kind, b, seed):
    """Pre-write lengths (`index`) of a decode step: generate's draw as
    chip_smoke.py makes it (prompt lengths 128-512 plus up to 64 new
    tokens), every slot at L - 1, or uniform over the whole cache."""
    if kind == "generate":
        return np.random.default_rng(seed).integers(128, 512 + 64 + 1,
                                                    size=b)
    if kind == "full":
        return np.full(b, L - 1)
    return np.random.default_rng(seed + 2).integers(0, L, size=b)


def call_decode(lib, q, ck, cv, idx, out):
    b, s, h, d = q.shape
    _raise("shellac_decode_attention", lib.shellac_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), idx.data_ptr(), None,
        out.data_ptr(), b, s, h, ck.shape[1], ck.shape[2], d, d ** -0.5, -1,
        0.0, BF16, _stream()))


def call_decode_int8(lib, q, ck, cv, ks, vs, idx, out):
    b, s, h, d = q.shape
    _raise("shellac_decode_attention_int8", lib.shellac_decode_attention_int8(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), idx.data_ptr(), None, out.data_ptr(), b, s, h,
        ck.shape[1], ck.shape[2], d, d ** -0.5, -1, 0.0, BF16, _stream()))


def run_decode_int8(libs, gen, dev, card, seed):
    from shellac_tpu_torch.inference.cache import quantize_kv
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _dequantize,
    )

    bf = torch.bfloat16
    ok = True
    for name, (b, kind, (H, HKV, D)) in DECODE_SHAPES.items():
        lengths = decode_lengths(kind, b, seed).astype(np.int32)
        idx = torch.from_numpy(lengths).to(dev)

        def make():
            q = torch.randn((b, 1, H, D), generator=gen, device=dev).to(bf)
            ck, ks = (t[0] for t in quantize_kv(torch.randn(
                (1, b, HKV, L, D), generator=gen, device=dev)))
            cv, vs = (t[0] for t in quantize_kv(torch.randn(
                (1, b, HKV, L, D), generator=gen, device=dev)))
            return q, ck, cv, ks, vs, idx, torch.empty_like(q)

        # Bytes: q and out, the live int8 k/v rows and their fp32 scales
        # (2 D + 8 bytes per position and kv head), index.
        live = int((lengths + 1).sum())
        nbytes = 2 * b * H * D * 2 + live * HKV * (2 * D + 8) + b * 4
        first = make()
        sets = [first] + [make() for _ in range(n_copies(first, nbytes) - 1)]
        q, ck, cv, ks, vs = first[:5]
        ref = _decode_ref(q, ck, cv, idx, None, D ** -0.5, k_scale=ks,
                          v_scale=vs)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            call_decode_int8(lib, q, ck, cv, ks, vs, idx, out)
            torch.cuda.synchronize()
            errs[who] = close(out, ref)
            ok = ok and errs[who]["ok"]
        iters = 200
        times, eager = ab(libs, lambda lib: lambda *a: call_decode_int8(
            lib, *a), sets, iters)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def library(q, ck, cv, ks, vs, i, o):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), _dequantize(ck, ks, bf),
                _dequantize(cv, vs, bf), attn_mask=mask, enable_gqa=True)

        calls = graph_ms(library, sets, 50)
        bms, by = bound(4 * D * H * live, nbytes)
        new_ms = min(times["new"])
        print(json.dumps({
            "pass": "dense-int8", "shape": name, "b": b, "s": 1, "h": H,
            "hkv": HKV, "L": L, "d": D, "index": idx.tolist(),
            "ms": times, "eager_ms": eager, "library_calls_ms": calls,
            "library_calls_what": "dequantize k and v + SDPA",
            "bound_ms": bms, "bound_by": by, "roofline_share": bms / new_ms,
            "parent_over_new": min(times["parent"]) / new_ms,
            "new_over_library_calls": new_ms / calls,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def run_decode(libs, gen, dev, card, seed):
    from shellac_tpu_torch.ops.decode_attention import _decode_ref

    bf = torch.bfloat16
    ok = True
    for name, (b, kind, (H, HKV, D)) in DECODE_SHAPES.items():
        lengths = decode_lengths(kind, b, seed).astype(np.int32)
        idx = torch.from_numpy(lengths).to(dev)

        def make():
            q = torch.randn((b, 1, H, D), generator=gen, device=dev).to(bf)
            ck = torch.randn((b, HKV, L, D), generator=gen,
                             device=dev).to(bf)
            cv = torch.randn((b, HKV, L, D), generator=gen,
                             device=dev).to(bf)
            return q, ck, cv, idx, torch.empty_like(q)

        # A step reads only the live rows, so count those against the L2.
        live = int((lengths + 1).sum())  # kv positions the step reads
        nbytes = 2 * b * H * D * 2 + 2 * live * HKV * D * 2 + b * 4
        first = make()
        sets = [first] + [make() for _ in range(n_copies(first, nbytes) - 1)]
        q, ck, cv = first[:3]
        ref = _decode_ref(q, ck, cv, idx, None, D ** -0.5)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            call_decode(lib, q, ck, cv, idx, out)
            torch.cuda.synchronize()
            errs[who] = close(out, ref)
            ok = ok and errs[who]["ok"]
        iters = 200
        times, eager = ab(libs, lambda lib: lambda q, k, v, i, o:
                          call_decode(lib, q, k, v, i, o), sets, iters)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]
        sdpa = graph_ms(lambda q, k, v, i, o: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True), sets,
            iters)
        bms, by = bound(4 * D * H * live, nbytes)
        new_ms = min(times["new"])
        print(json.dumps({
            "pass": "decode", "shape": name, "b": b, "s": 1, "h": H,
            "hkv": HKV, "L": L, "d": D, "index": idx.tolist(),
            "ms": times, "eager_ms": eager, "masked_sdpa_ms": sdpa,
            "bound_ms": bms, "bound_by": by, "roofline_share": bms / new_ms,
            "parent_over_new": min(times["parent"]) / new_ms,
            "new_over_library": new_ms / sdpa,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def call_paged(lib, q, pk, pv, pks, pvs, tab, idx, out):
    b, s, h, d = q.shape
    hkv, bs = pk.shape[1], pk.shape[2]
    tail = (None, out.data_ptr(), b, s, h, hkv, bs, tab.shape[1], d,
            d ** -0.5, -1, 0.0, BF16, _stream())
    if pks is None:
        _raise("shellac_paged_decode_attention",
               lib.shellac_paged_decode_attention(
                   q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                   tab.data_ptr(), idx.data_ptr(), *tail))
    else:
        _raise("shellac_paged_decode_attention_int8",
               lib.shellac_paged_decode_attention_int8(
                   q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                   pks.data_ptr(), pvs.data_ptr(), tab.data_ptr(),
                   idx.data_ptr(), *tail))


def paged_set(gen, dev, lengths, bs, quant, heads):
    """q, a pool (bf16, or int8 with fp32 scale pools) holding each slot's
    pages for positions [0, length + 1) in shuffled blocks, the tables,
    index and an output buffer; heads (H, Hkv, D)."""
    from shellac_tpu_torch.inference.cache import quantize_kv

    H, HKV, D = heads
    need = [-(-(int(n) + 1) // bs) for n in lengths]
    n_blocks = 1 + sum(need) + 64
    ids = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tab = torch.zeros((len(need), L // bs), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(need):
        tab[b, :n] = ids[at:at + n].to(torch.int32)
        at += n
    q = torch.randn((len(need), 1, H, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    shape = (n_blocks, HKV, bs, D)
    pools = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev)
        pools.append(quantize_kv(x[None]) if quant else (x.to(
            torch.bfloat16)[None], None))
    (pk, pks), (pv, pvs) = pools
    pk, pv = pk[0], pv[0]
    if quant:
        pks, pvs = pks[0], pvs[0]
    idx = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    return q, pk, pv, pks, pvs, tab, idx, torch.empty_like(q)


def run_paged(libs, gen, dev, card, seed):
    from shellac_tpu_torch.inference.cache import (
        paged_gather_layer,
        paged_gather_scales,
    )
    from shellac_tpu_torch.ops.decode_attention import (
        _dequantize,
        _paged_decode_ref,
    )

    bf = torch.bfloat16
    ok = True
    for name, (pool, bs, kind, heads) in PAGED_SHAPES.items():
        H, HKV, D = heads
        quant = pool == "int8"
        lengths = (np.full(SLOTS, L - 1) if kind == "full" else
                   np.random.default_rng(seed + 1).integers(
                       64, 1024 + 128 + 1, size=SLOTS))
        live = int((lengths + 1).sum())  # kv positions the step reads
        pages = int(sum(-(-(int(n) + 1) // bs) for n in lengths))
        # Bytes: q and out, the live k/v rows (and their fp32 scales), the
        # live table entries, index.
        row_bytes = (2 * D + 8) if quant else 2 * D * 2
        nbytes = (2 * SLOTS * H * D * 2 + live * HKV * row_bytes
                  + pages * 4 + SLOTS * 4)
        first = paged_set(gen, dev, lengths, bs, quant, heads)
        sets = [first] + [paged_set(gen, dev, lengths, bs, quant, heads)
                          for _ in range(n_copies(first, nbytes) - 1)]
        q, pk, pv, pks, pvs, tab, idx, _ = first
        ref = _paged_decode_ref(q, pk, pv, tab, idx, None, D ** -0.5,
                                k_scale=pks, v_scale=pvs)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            call_paged(lib, q, pk, pv, pks, pvs, tab, idx, out)
            torch.cuda.synchronize()
            errs[who] = close(out, ref)
            ok = ok and errs[who]["ok"]
        iters = 200
        times, eager = ab(libs, lambda lib: lambda *a: call_paged(lib, *a),
                          sets, iters)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def library(q, pk, pv, pks, pvs, tab, i, o):
            kk, vv = paged_gather_layer(pk, pv, tab)
            if pks is not None:
                kk = _dequantize(kk, paged_gather_scales(pks, tab), bf)
                vv = _dequantize(vv, paged_gather_scales(pvs, tab), bf)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)

        calls = graph_ms(library, sets, 50)
        bms, by = bound(4 * D * H * live, nbytes)
        new_ms = min(times["new"])
        print(json.dumps({
            "pass": "paged", "shape": name, "pool": pool, "bs": bs,
            "b": SLOTS, "s": 1, "h": H, "hkv": HKV, "max_blocks": L // bs,
            "d": D, "index": [int(n) for n in lengths],
            "ms": times, "eager_ms": eager, "library_calls_ms": calls,
            "library_calls_what": ("gather + dequantize + SDPA" if quant
                                   else "gather + SDPA"),
            "bound_ms": bms, "bound_by": by, "roofline_share": bms / new_ms,
            "parent_over_new": min(times["parent"]) / new_ms,
            "new_over_library_calls": new_ms / calls,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def mla_set(gen, dev, cache, pool, b, heads, bs, lengths):
    """q (b, 1, heads, 576) bf16 and one latent array serving as k and v:
    a dense cache (b, 1, L, 576) or a pool of shuffled pages holding each
    slot's positions [0, length + 1) (int8 with one fp32 scale a row when
    `pool` is "int8"); (tables or None, scales or None, index, out)."""
    from shellac_tpu_torch.inference.cache import quantize_kv

    q = torch.randn((b, 1, heads, MLA_D), generator=gen,
                    device=dev).to(torch.bfloat16)
    if cache == "dense":
        shape, tab = (b, 1, L, MLA_D), None
    else:
        need = [-(-(int(n) + 1) // bs) for n in lengths]
        n_blocks = 1 + sum(need) + 64
        ids = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
        tab = torch.zeros((b, L // bs), dtype=torch.int32, device=dev)
        at = 0
        for i, n in enumerate(need):
            tab[i, :n] = ids[at:at + n].to(torch.int32)
            at += n
        shape = (n_blocks, 1, bs, MLA_D)
    x = torch.randn(shape, generator=gen, device=dev)
    if pool == "int8":
        c, sc = (t[0] for t in quantize_kv(x[None]))
    else:
        c, sc = x.to(torch.bfloat16), None
    idx = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    return q, c, sc, tab, idx, torch.empty_like(q)


def call_mla(lib, q, c, sc, tab, idx, out):
    if tab is not None:
        call_paged(lib, q, c, c, sc, sc, tab, idx, out)
    elif sc is not None:
        call_decode_int8(lib, q, c, c, sc, sc, idx, out)
    else:
        call_decode(lib, q, c, c, idx, out)


def run_mla(libs, gen, dev, card, seed):
    """Kernels 5-7 at MLA's 576: the absorbed decode's latent as k and v."""
    from shellac_tpu_torch.inference.cache import (
        paged_gather_layer,
        paged_gather_scales,
    )
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _dequantize,
        _paged_decode_ref,
    )

    bf = torch.bfloat16
    scale = MLA_D ** -0.5
    ok = True
    for name, (cache, pool, b, heads, bs, kind) in MLA_SHAPES.items():
        lengths = (np.full(b, L - 1) if kind == "full" else
                   decode_lengths("generate", b, seed) if cache == "dense"
                   else np.random.default_rng(seed + 1).integers(
                       64, 1024 + 128 + 1, size=b))
        quant = pool == "int8"
        live = int((lengths + 1).sum())
        pages = (0 if cache == "dense" else
                 int(sum(-(-(int(n) + 1) // bs) for n in lengths)))
        # Bytes: q and out, the live latent rows once (k and v are one
        # array) and their scales, the live table entries, index.
        nbytes = (2 * b * heads * MLA_D * 2
                  + live * (MLA_D * (1 if quant else 2) + (4 if quant else 0))
                  + pages * 4 + b * 4)
        first = mla_set(gen, dev, cache, pool, b, heads, bs, lengths)
        sets = [first] + [mla_set(gen, dev, cache, pool, b, heads, bs,
                                  lengths)
                          for _ in range(n_copies(first, nbytes) - 1)]
        q, c, sc, tab, idx, _ = first
        kw = {} if sc is None else dict(k_scale=sc, v_scale=sc)
        ref = (_decode_ref(q, c, c, idx, None, scale, **kw) if tab is None
               else _paged_decode_ref(q, c, c, tab, idx, None, scale, **kw))
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            call_mla(lib, q, c, sc, tab, idx, out)
            torch.cuda.synchronize()
            errs[who] = close(out, ref)
            ok = ok and errs[who]["ok"]
        del ref
        times, eager = ab(libs, lambda lib: lambda *a: call_mla(lib, *a),
                          sets, 200)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def library(q, c, sc, tab, i, o):
            if tab is not None:
                kv = paged_gather_layer(c, c, tab)[0]
                if sc is not None:
                    kv = _dequantize(kv, paged_gather_scales(sc, tab), bf)
            else:
                kv = c if sc is None else _dequantize(c, sc, bf)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kv, kv, attn_mask=mask, scale=scale,
                enable_gqa=True)

        calls = graph_ms(library, sets, 20)
        bms, by = bound(4 * MLA_D * heads * live, nbytes)
        new_ms = min(times["new"])
        what = ("masked SDPA" if cache == "dense" and not quant else
                " + ".join(w for w, on in (("gather", tab is not None),
                                            ("dequantize", quant)) if on)
                + " + masked SDPA")
        print(json.dumps({
            "pass": "mla", "shape": name, "cache": cache, "pool": pool,
            "b": b, "s": 1, "h": heads, "hkv": 1, "d": MLA_D, "bs": bs,
            "index": [int(n) for n in lengths],
            "ms": times, "eager_ms": eager, "library_calls_ms": calls,
            "library_calls_what": what,
            "bound_ms": bms, "bound_by": by, "roofline_share": bms / new_ms,
            "parent_over_new": min(times["parent"]) / new_ms,
            "new_over_library_calls": new_ms / calls,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def run_fwd(libs, gen, dev, card):
    from shellac_tpu_torch.ops.flash_attention import flash_forward_ref

    bf = torch.bfloat16
    ok = True
    for name, (b, s, with_lse) in FWD_SHAPES.items():
        def make():
            q = torch.randn((b, s, H, D), generator=gen, device=dev).to(bf)
            k = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            v = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            lse = torch.empty((b, H, s), device=dev) if with_lse else None
            return q, k, v, torch.empty_like(q), lse

        first = make()
        sets = [first] + [make() for _ in range(n_copies(first[:4]) - 1)]
        q, k, v, _, _ = first
        ref, rlse = flash_forward_ref(q, k, v, causal=True)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            lse = torch.empty((b, H, s), device=dev)
            call_fwd(lib, q, k, v, out, lse)
            torch.cuda.synchronize()
            e, le = close(out, ref), close(lse, rlse)
            errs[who] = {"max_abs_err": e["max_abs_err"],
                         "lse_max_abs_err": le["max_abs_err"],
                         "ok": e["ok"] and le["ok"]}
            ok = ok and errs[who]["ok"]
        iters = 10 if b * s >= 4096 else 50
        times, eager = ab(
            libs, lambda lib: lambda q, k, v, o, l: call_fwd(
                lib, q, k, v, o, l), sets, iters)
        sdpa = graph_ms(
            lambda q, k, v, o, l: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), sets, iters)
        pairs = b * H * s * (s + 1) // 2  # causal (q, k) pairs
        flops = 4 * D * pairs
        nbytes = 2 * (2 * b * s * H * D + 2 * b * s * HKV * D) \
            + (4 * b * H * s if with_lse else 0)
        bms, by = bound(flops, nbytes)
        new_ms = min(times["new"])
        print(json.dumps({
            "pass": "fwd", "shape": name, "b": b, "s": s, "h": H,
            "hkv": HKV, "d": D, "causal": True, "with_lse": with_lse,
            "ms": times, "eager_ms": eager, "sdpa_ms": sdpa, "bound_ms": bms, "bound_by": by,
            "new_tflops": flops / (new_ms * 1e-3) / 1e12,
            "parent_over_new": min(times["parent"]) / new_ms,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def run_bwd(libs, gen, dev, card):
    from shellac_tpu_torch.ops.flash_attention import (
        flash_bwd_dkdv_ref,
        flash_bwd_dq_ref,
        flash_forward_ref,
    )

    bf = torch.bfloat16
    ok = True
    for name, (b, s, h, hkv, d, dv_live) in BWD_SHAPES.items():
        def make():
            def rnd(heads, width):
                x = torch.randn((b, s, heads, width), generator=gen,
                                device=dev).to(bf)
                return F.pad(x, (0, d - width)).contiguous()

            q, k = rnd(h, d), rnd(hkv, d)
            v, do = rnd(hkv, dv_live), rnd(h, dv_live)
            out, lse = torch.empty_like(q), torch.empty((b, h, s),
                                                        device=dev)
            call_fwd(libs["new"], q, k, v, out, lse)
            dl = torch.einsum("bshd,bshd->bhs", do.float(),
                              out.float()).contiguous()
            return (q, k, v, do, lse, dl, torch.empty_like(q),
                    torch.empty_like(k), torch.empty_like(v))

        first = make()
        sets = [first] + [make() for _ in range(n_copies(first[:6]) - 1)]
        q, k, v, do, lse, dl = first[:6]
        rdk, rdv = flash_bwd_dkdv_ref(q, k, v, do, lse, dl)
        rdq = flash_bwd_dq_ref(q, k, v, do, lse, dl)
        errs = {}
        for who, lib in libs.items():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            call_dkdv(lib, q, k, v, do, lse, dl, dk, dv)
            call_dq(lib, q, k, v, do, lse, dl, dq)
            torch.cuda.synchronize()
            errs[who] = {n: close(x, r, scaled=True) for n, x, r in
                         (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
            ok = ok and all(e["ok"] for e in errs[who].values())
        del rdk, rdv, rdq
        iters = 10 if b * s >= 4096 else 50
        t3, e3 = ab(libs, lambda lib: lambda q, k, v, do, l, d, dq, dk, dv:
                    call_dkdv(lib, q, k, v, do, l, d, dk, dv), sets, iters)
        t4, e4 = ab(libs, lambda lib: lambda q, k, v, do, l, d, dq, dk, dv:
                    call_dq(lib, q, k, v, do, l, d, dq), sets, iters)

        def sdpa_set(q, k, v, do, *_):
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
            return qt, kt, vt, out, do.transpose(1, 2)

        lib_sets = [sdpa_set(*a) for a in sets]
        sdpa = eager_ms(lambda qt, kt, vt, out, dot: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), lib_sets, iters)
        del lib_sets
        pairs = b * h * s * (s + 1) // 2
        qb, kb, rb = b * s * h * d * 2, b * s * hkv * d * 2, b * h * s * 4
        rows = {}
        for kern, times, eager, flops, nbytes in (
                ("dkdv", t3, e3, 8 * d * pairs, 2 * qb + 4 * kb + 2 * rb),
                ("dq", t4, e4, 6 * d * pairs, 3 * qb + 2 * kb + 2 * rb)):
            bms, by = bound(flops, nbytes)
            new_ms = min(times["new"])
            rows[kern] = {
                "ms": times, "eager_ms": eager, "bound_ms": bms,
                "bound_by": by, "roofline_share": bms / new_ms,
                "new_tflops": flops / (new_ms * 1e-3) / 1e12,
                "parent_over_new": min(times["parent"]) / new_ms}
        pair_new = min(a + b_ for a, b_ in zip(t3["new"], t4["new"]))
        print(json.dumps({
            "pass": "bwd", "shape": name, "b": b, "s": s, "h": h,
            "hkv": hkv, "d": d, "v_live": dv_live, "causal": True, **rows,
            "sdpa_backward_eager_ms": sdpa,
            "new_pair_over_sdpa_backward": pair_new / sdpa,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def greedy(cfg, params, toks, lens, steps):
    """Greedy decoding through the port's kernels: the tokens (B, steps)
    and the fp32 logits each token was chosen from (steps, B, V)."""
    from shellac_tpu_torch.inference.cache import init_cache
    from shellac_tpu_torch.models import transformer

    b = toks.shape[0]
    cache = init_cache(cfg, b, L, toks.device)
    logits, cache = transformer.forward_with_cache(
        cfg, params, toks, cache, new_tokens_len=lens, fresh_cache=True)
    last = logits[torch.arange(b, device=toks.device), lens.long() - 1]
    out, seen = [], []
    for _ in range(steps):
        seen.append(last.float())
        tok = last.float().argmax(-1)
        out.append(tok)
        logits, cache = transformer.forward_with_cache(cfg, params,
                                                       tok[:, None], cache)
        last = logits[:, 0]
    return torch.stack(out, 1), torch.stack(seen)


def run_generate(libs, dev, card, seed, prompts=8, pad=512, steps=64):
    """Greedy tokens of shellac-1b on each side's kernels (the wrappers
    call whichever library `_build.library` returns)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops import _build

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed)  # as chip_smoke.py's prompts
    lens = torch.from_numpy(rng.integers(128, 512 + 1, size=prompts).astype(
        np.int32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        prompts, pad))).to(dev)
    own = _build.library
    runs = {}
    try:
        with torch.inference_mode():
            for who, lib in libs.items():
                _build.library = lambda lib=lib: lib
                runs[who] = greedy(cfg, params, toks, lens, steps)
    finally:
        _build.library = own
    (tp, lp), (tn, ln) = runs["parent"], runs["new"]
    parted = []
    for row in range(prompts):
        diff = (tp[row] != tn[row]).nonzero()
        if len(diff) == 0:
            continue
        t = int(diff[0])
        top2 = lp[t, row].topk(2).values
        parted.append({
            "row": row, "step": t,
            "parent_top2_margin": float(top2[0] - top2[1]),
            "max_logit_diff_at_step": float(
                (lp[t, row] - ln[t, row]).abs().max())})
    print(json.dumps({
        "pass": "generate", "model": "shellac-1b", "prompts": prompts,
        "new_tokens": steps, "rows_equal": prompts - len(parted),
        "tokens_equal": float((tp == tn).float().mean()),
        "parted": parted, "card": card}), flush=True)


def load_libs(checkouts):
    """{name: checkout} -> {name: loaded kernel library}, each built from
    its own sources."""
    libs = {}
    for who, path in checkouts.items():
        mod = load_build(path.resolve(), f"{who}_build")
        info = mod.build_info()
        print(json.dumps({"build": who, "seconds": info["seconds"],
                          "dir": info["dir"]}), flush=True)
        libs[who] = mod.library()
    return libs


PASSES = ("rms", "fwd", "bwd", "decode", "dense-int8", "paged", "mla",
          "generate")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(PASSES),
                    help="comma-separated passes of " + ", ".join(PASSES))
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to time")
    args = ap.parse_args()
    passes = args.only.split(",")
    if not set(passes) <= set(PASSES):
        ap.error(f"--only: passes are {PASSES}")
    checkouts = {"parent": args.parent, "new": ROOT}
    for spec in args.also:
        name, sep, path = spec.partition("=")
        if not sep or name in checkouts:
            ap.error(f"--also {spec!r}: NAME=DIR, NAME not parent or new")
        checkouts[name] = Path(path)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = load_libs(checkouts)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    if "rms" in passes:
        ok = run_rms(libs, gen, dev, card) and ok
    if "fwd" in passes:
        ok = run_fwd(libs, gen, dev, card) and ok
    if "bwd" in passes:
        ok = run_bwd(libs, gen, dev, card) and ok
    if "decode" in passes:
        ok = run_decode(libs, gen, dev, card, args.seed) and ok
    if "dense-int8" in passes:
        ok = run_decode_int8(libs, gen, dev, card, args.seed) and ok
    if "paged" in passes:
        ok = run_paged(libs, gen, dev, card, args.seed) and ok
    if "mla" in passes:
        ok = run_mla(libs, gen, dev, card, args.seed) and ok
    if "generate" in passes:
        run_generate(libs, dev, card, args.seed)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
