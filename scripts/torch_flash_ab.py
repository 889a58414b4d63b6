"""Time the port's bf16 flash-attention kernels of two checkouts on one
CUDA card: kernel 2 (the forward) and kernels 3 and 4 (the backward's
dk/dv and dq).

    python3 scripts/torch_flash_ab.py --parent DIR [--seed 0] [--only fwd|bwd]

DIR is a checkout of an earlier commit of this repository (for example
unpacked with `git archive` into a directory that .gitignore lists). Each
checkout's kernel library is built from its own sources into its own
`build/` directory, both are loaded side by side and called through the
same C entry points (`shellac_flash_attention`,
`shellac_flash_attention_bwd_dkdv`, `shellac_flash_attention_bwd_dq`) on
the same inputs. All shapes are causal with H 16, Hkv 8, D 128, as
shellac-1b. The forward is timed at the shapes the port's main paths give
kernel 2: the train step (6 x 2048, with lse), generate's prefill (8 x
512) and serve's B = 1 admissions (S 64, 256 and 1024); the backward at
the train step (6 x 2048), B = 1 at S 2048, and 8 x 512. Each shape is
timed by CUDA-graph replay (device time) and by eager calls back to back
in the order parent, this tree, this tree, parent, with PyTorch's
scaled_dot_product_attention beside it as a yardstick (for the backward,
its backward call, which computes dq, dk and dv together; timed eagerly,
since autograd is not captured). Prints the card's name and power limit,
then one JSON line a shape and pass. Exits non-zero without a card, or if
either side disagrees with the plain versions (`flash_forward_ref`,
`flash_bwd_dkdv_ref`, `flash_bwd_dq_ref`) beyond the bf16 tolerance
(2e-2 + 2e-2 |ref|; for the gradients 2e-2 max|ref| + 2e-2 |ref|).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

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
BWD_SHAPES = {  # name: (B, S)
    "train_6x2048": (6, 2048),
    "b1_2048": (1, 2048),
    "b8_512": (8, 512),
}
H, HKV, D = 16, 8, 128
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


def n_copies(first):
    """Input sets to cycle through so that one pass exceeds the L2."""
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
    """Graph and eager ms of each side, in the order parent, new, new,
    parent."""
    times = {"parent": [], "new": []}
    eager = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        fn = fn_of(libs[who])
        times[who].append(graph_ms(fn, sets, iters))
        eager[who].append(eager_ms(fn, sets, iters))
    return times, eager


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
            "parent_ms": times["parent"], "new_ms": times["new"],
            "parent_eager_ms": eager["parent"], "new_eager_ms": eager["new"],
            "sdpa_ms": sdpa, "bound_ms": bms, "bound_by": by,
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
    for name, (b, s) in BWD_SHAPES.items():
        def make():
            q = torch.randn((b, s, H, D), generator=gen, device=dev).to(bf)
            k = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            v = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            do = torch.randn((b, s, H, D), generator=gen, device=dev).to(bf)
            out, lse = torch.empty_like(q), torch.empty((b, H, s),
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
        pairs = b * H * s * (s + 1) // 2
        qb, kb, rb = b * s * H * D * 2, b * s * HKV * D * 2, b * H * s * 4
        rows = {}
        for kern, times, eager, flops, nbytes in (
                ("dkdv", t3, e3, 8 * D * pairs, 2 * qb + 4 * kb + 2 * rb),
                ("dq", t4, e4, 6 * D * pairs, 3 * qb + 2 * kb + 2 * rb)):
            bms, by = bound(flops, nbytes)
            new_ms = min(times["new"])
            rows[kern] = {
                "parent_ms": times["parent"], "new_ms": times["new"],
                "parent_eager_ms": eager["parent"],
                "new_eager_ms": eager["new"], "bound_ms": bms,
                "bound_by": by, "roofline_share": bms / new_ms,
                "new_tflops": flops / (new_ms * 1e-3) / 1e12,
                "parent_over_new": min(times["parent"]) / new_ms}
        pair_new = min(a + b_ for a, b_ in zip(t3["new"], t4["new"]))
        print(json.dumps({
            "pass": "bwd", "shape": name, "b": b, "s": s, "h": H,
            "hkv": HKV, "d": D, "causal": True, **rows,
            "sdpa_backward_eager_ms": sdpa,
            "new_pair_over_sdpa_backward": pair_new / sdpa,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {"parent": load_build(args.parent.resolve(), "parent_build"),
            "new": load_build(ROOT, "new_build")}
    for who, mod in libs.items():
        info = mod.build_info()
        print(json.dumps({"build": who, "seconds": info["seconds"],
                          "dir": info["dir"]}), flush=True)
    libs = {who: mod.library() for who, mod in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    if args.only != "bwd":
        ok = run_fwd(libs, gen, dev, card) and ok
    if args.only != "fwd":
        ok = run_bwd(libs, gen, dev, card) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
