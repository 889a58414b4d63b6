"""Time kernel 2, the port's bf16 flash-attention forward, of two checkouts
on one CUDA card.

    python3 scripts/torch_flash_fwd_ab.py --parent DIR [--seed 0]

DIR is a checkout of an earlier commit of this repository (for example
unpacked with `git archive` into a directory that .gitignore lists). Each
checkout's kernel library is built from its own sources into its own
`build/` directory, both are loaded side by side and called through the
same C entry point, `shellac_flash_attention`, on the same inputs, at the
shapes the port's main paths give kernel 2: the train step (6 x 2048,
with lse), generate's prefill (8 x 512) and serve's B = 1 admissions (S
64, 256 and 1024); all with H 16, Hkv 8, D 128, causal, as shellac-1b.
Each shape is timed by CUDA-graph replay (device time) and by eager
calls back to back (which the launcher's host cost bounds at small
shapes) in the order parent, this tree, this tree, parent, with one call
of PyTorch's scaled_dot_product_attention beside it as a yardstick.
Prints the card's name and power limit, then one JSON line a shape.
Exits non-zero without a card, or if either kernel disagrees with the
plain version (`flash_forward_ref`) beyond the bf16 tolerance (2e-2 +
2e-2 |ref|).
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
SHAPES = {  # name: (B, S, with lse)
    "train_6x2048_lse": (6, 2048, True),
    "generate_8x512": (8, 512, False),
    "serve_1x1024": (1, 1024, False),
    "serve_1x256": (1, 256, False),
    "serve_1x64": (1, 64, False),
}
H, HKV, D = 16, 8, 128


def load_build(checkout: Path, name: str):
    path = checkout / "shellac_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call(lib, q, k, v, out, lse):
    b, s, h, d = q.shape
    err = lib.shellac_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h,
        k.shape[2], d, d ** -0.5, 1, -1, 0.0, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"shellac_flash_attention: cudaError_t {err}")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    from shellac_tpu_torch.ops.flash_attention import flash_forward_ref

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
    bf = torch.bfloat16
    ok = True
    for name, (b, s, with_lse) in SHAPES.items():
        def make():
            q = torch.randn((b, s, H, D), generator=gen, device=dev).to(bf)
            k = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            v = torch.randn((b, s, HKV, D), generator=gen, device=dev).to(bf)
            lse = torch.empty((b, H, s), device=dev) if with_lse else None
            return q, k, v, torch.empty_like(q), lse

        first = make()
        nbytes = sum(t.numel() * t.element_size() for t in first[:4])
        n = min(16, max(1, -(-(256 << 20) // nbytes)))  # past the L2
        sets = [first] + [make() for _ in range(n - 1)]
        q, k, v, _, _ = first
        ref, rlse = flash_forward_ref(q, k, v, causal=True)
        errs = {}
        for who, lib in libs.items():
            out = torch.empty_like(q)
            lse = torch.empty((b, H, s), device=dev)
            call(lib, q, k, v, out, lse)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            good = bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all())
            lerr = (lse - rlse).abs()
            good = good and bool(
                (lerr <= 2e-2 + 2e-2 * rlse.abs()).all())
            errs[who] = {"max_abs_err": err.max().item(),
                         "lse_max_abs_err": lerr.max().item(), "ok": good}
            ok = ok and good
        iters = 10 if b * s >= 4096 else 50
        times = {"parent": [], "new": []}
        eager = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            lib = libs[who]
            fn = lambda q, k, v, o, l, lib=lib: call(lib, q, k, v, o, l)
            times[who].append(graph_ms(fn, sets, iters))
            eager[who].append(eager_ms(fn, sets, iters))
        sdpa = graph_ms(
            lambda q, k, v, o, l: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), sets, iters)
        pairs = b * H * s * (s + 1) // 2  # causal (q, k) pairs
        flops = 4 * D * pairs
        nbytes = 2 * (2 * b * s * H * D + 2 * b * s * HKV * D) \
            + (4 * b * H * s if with_lse else 0)
        bound = max(flops / PEAK_BF16_S, nbytes / PEAK_BYTES_S) * 1e3
        new_ms = min(times["new"])
        print(json.dumps({
            "shape": name, "b": b, "s": s, "h": H, "hkv": HKV, "d": D,
            "causal": True, "with_lse": with_lse,
            "parent_ms": times["parent"], "new_ms": times["new"],
            "parent_eager_ms": eager["parent"], "new_eager_ms": eager["new"],
            "sdpa_ms": sdpa, "bound_ms": bound,
            "bound_by": "operations" if flops / PEAK_BF16_S
            >= nbytes / PEAK_BYTES_S else "bytes",
            "new_tflops": flops / (new_ms * 1e-3) / 1e12,
            "parent_over_new": min(times["parent"]) / new_ms,
            "errors": errs, "card": card}), flush=True)
        del sets, first
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
