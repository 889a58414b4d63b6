"""Run `chip_smoke.py` of two checkouts on one CUDA card in the order
parent, this tree, this tree, parent, and set their end-to-end numbers
side by side.

    python3 scripts/torch_smoke_ab.py --parent DIR [--out DIR]
        [--only PHASES]

DIR is a checkout of an earlier commit of this repository (for example
unpacked with `git archive` into a directory that .gitignore lists). Each
run is `python3 chip_smoke.py` from the root of its checkout, which
builds that checkout's kernels; its full output goes to
OUT/smoke_<n>_<side>.jsonl (default build/smoke_ab/). Then one JSON line a
metric, {"metric": ..., "parent": [first run, last run], "new": [second,
third]}: the train step (every loss, step ms, tokens/s, peak memory, the
profiled step's device ms, busy share and device ms by kernel kind, the
LM head's GEMMs where the run reports them apart), the device ms of
serve's and serve-int8's profiled engine step (and their device ms by
kernel kind) and of generate's graph-captured decode step (and its
profiled step's device ms by kernel kind), the host metrics of serve, serve-int8 and generate, the launch
counts of every main path, and every kernel's timings; the MLA models'
serve (shellac-mla-2b over the bf16 and int8 pools, DeepSeek-V2-Lite's
shape) and GPT-OSS-20B's: tokens/s, TPOT p50, the 16-slot decode step's
device ms and its device ms by kernel kind. `--only PHASES` passes
chip_smoke.py's `--only` (for example `mla,moe`: those phases after the
build, whose lines are the only ones filled). Exits non-zero without a
card, if a run fails, or if the first train step's loss of a run of this
tree differs from the parent's first run by more than 1e-3 relative
(where the train phase ran).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def run_smoke(checkout: Path, out: Path, only=None) -> dict:
    """One chip_smoke.py run: its exit code and JSON lines by key, (phase,
    step or kernel, case) and, for a line that names its model, (phase,
    step, model, cache)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"] + (["--only", only] if only
                                             else []),
        cwd=checkout, capture_output=True, text=True, timeout=1500)
    out.write_text(res.stdout + "\n--- stderr ---\n" + res.stderr)
    lines = {}
    for ln in res.stdout.splitlines():
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        if isinstance(rec, dict) and "phase" in rec:
            key = (rec["phase"], rec.get("step") or rec.get("kernel"),
                   rec.get("case"))
            lines.setdefault(key, rec)
            if "model" in rec:
                lines.setdefault((rec["phase"], rec.get("step"),
                                  rec["model"], rec.get("cache")), rec)
        elif isinstance(rec, dict) and "ok" in rec:
            lines["ok"] = rec["ok"]
    return {"rc": res.returncode, "seconds": time.perf_counter() - t0,
            "lines": lines}


def pick(run, key, *fields):
    rec = run["lines"].get(key)
    if rec is None:
        return None
    for f in fields:
        if not isinstance(rec, dict) or f not in rec:
            return None
        rec = rec[f]
    return rec


METRICS = {  # name: (key of the line, fields inside it)
    "train_losses": (("train", "main_path", None), ("losses",)),
    "train_first_step_loss": (("train", "main_path", None),
                              ("warmup_step_loss",)),
    "train_step_ms": (("train", "main_path", None), ("step_ms",)),
    "train_tokens_per_s": (("train", "main_path", None), ("tokens_per_s",)),
    "train_model_tflops_per_s": (("train", "main_path", None),
                                 ("model_tflops_per_s",)),
    "train_max_memory_allocated": (("train", "main_path", None),
                                   ("max_memory_allocated",)),
    "train_launches_10_steps": (("train", "main_path", None), ("launches",)),
    "train_device_step_ms": (("train", "profile_step", None), ("device_ms",)),
    "train_device_busy_share": (("train", "profile_step", None),
                                ("device_busy_share",)),
    "train_device_ms_by_kind": (("train", "profile_step", None),
                                ("device_ms_by_kind",)),
    "train_gemm_lm_head_ms": (("train", "profile_step", None),
                              ("gemm_lm_head_ms",)),
    "train_gemm_other_ms": (("train", "profile_step", None),
                            ("gemm_other_ms",)),
    "lm_head_profile_top": (("train", "profile_lm_head", None), ("top",)),
    "serve_step_device_ms": (("serve", "profile_engine_step", None),
                             ("device_ms",)),
    "serve_step_device_ms_by_kind": (("serve", "profile_engine_step", None),
                                     ("device_ms_by_kind",)),
    "serve_tokens_per_s": (("serve", "main_path", None), ("tokens_per_s",)),
    "serve_ttft_ms_p50": (("serve", "main_path", None), ("ttft_ms_p50",)),
    "serve_tpot_ms_p50": (("serve", "main_path", None), ("tpot_ms_p50",)),
    "serve_ttft_ms_p99": (("serve", "main_path", None), ("ttft_ms_p99",)),
    "serve_tpot_ms_p99": (("serve", "main_path", None), ("tpot_ms_p99",)),
    "serve_launches": (("serve", "main_path", None), ("launches",)),
    "serve_graphs_captured": (("serve", "main_path", None),
                              ("graphs_captured",)),
    "serve_step_wall_ms": (("serve", "profile_engine_step", None),
                           ("wall_ms",)),
    "serve_step_device_busy_share": (("serve", "profile_engine_step", None),
                                     ("device_busy_share",)),
    "serve_graph_ms_per_tick": (("serve", "decode_tick_wall", None),
                                ("graph_ms_per_tick",)),
    "serve_eager_ms_per_tick": (("serve", "decode_tick_wall", None),
                                ("eager_ms_per_tick",)),
    "serve_int8_step_device_ms": (("serve-int8", "profile_engine_step",
                                   None), ("device_ms",)),
    "serve_int8_step_device_ms_by_kind": (
        ("serve-int8", "profile_engine_step", None), ("device_ms_by_kind",)),
    "serve_int8_tokens_per_s": (("serve-int8", "main_path", None),
                                ("tokens_per_s",)),
    "serve_int8_ttft_ms_p50": (("serve-int8", "main_path", None),
                               ("ttft_ms_p50",)),
    "serve_int8_tpot_ms_p50": (("serve-int8", "main_path", None),
                               ("tpot_ms_p50",)),
    "serve_int8_launches": (("serve-int8", "main_path", None),
                            ("launches",)),
    "serve_int8_step_wall_ms": (("serve-int8", "profile_engine_step", None),
                                ("wall_ms",)),
    "serve_int8_step_device_busy_share": (
        ("serve-int8", "profile_engine_step", None), ("device_busy_share",)),
    "serve_int8_graph_ms_per_tick": (("serve-int8", "decode_tick_wall",
                                      None), ("graph_ms_per_tick",)),
    "serve_int8_eager_ms_per_tick": (("serve-int8", "decode_tick_wall",
                                      None), ("eager_ms_per_tick",)),
    "generate_decode_step_device_ms": (("generate", "timing", None),
                                       ("decode_step_device_ms",)),
    "generate_prefill_device_ms": (("generate", "profile_prefill", None),
                                   ("device_ms",)),
    "generate_prefill_ms": (("generate", "timing", None), ("prefill_ms",)),
    "generate_tokens_per_s": (("generate", "timing", None),
                              ("tokens_per_s",)),
    "generate_decode_ms_per_token": (("generate", "timing", None),
                                     ("decode_ms_per_token",)),
    "generate_graph_ms_per_tick": (("generate", "timing", None),
                                   ("graph_ms_per_tick",)),
    "generate_eager_ms_per_tick": (("generate", "timing", None),
                                   ("eager_ms_per_tick",)),
    "generate_decode_step_busy_share": (("generate", "timing", None),
                                        ("decode_step_busy_share",)),
    "generate_graph_loop_device_busy_share": (
        ("generate", "timing", None), ("graph_loop_device_busy_share",)),
    "generate_graph_tokens_equal_eager": (("generate", "timing", None),
                                          ("graph_tokens_equal_eager",)),
    "generate_launches": (("generate", "main_path", None), ("launches",)),
    "generate_graphs_captured": (("generate", "main_path", None),
                                 ("graphs_captured",)),
    "generate_int8_decode_step_device_ms": (
        ("generate-int8", "timing", None), ("decode_step_device_ms",)),
    "generate_int8_graph_ms_per_tick": (("generate-int8", "timing", None),
                                        ("graph_ms_per_tick",)),
    "generate_int8_eager_ms_per_tick": (("generate-int8", "timing", None),
                                        ("eager_ms_per_tick",)),
    "generate_int8_tokens_per_s": (("generate-int8", "main_path", None),
                                   ("tokens_per_s",)),
    "generate_int8_launches": (("generate-int8", "main_path", None),
                               ("launches",)),
    "generate_decode_step_device_ms_by_kind": (
        ("generate", "profile_decode_step", None), ("device_ms_by_kind",)),
    "kernel1_ms_4096x2048": (("timings", "rms_norm", "rms_prefill"),
                             ("ms",)),
    "kernel1_ms_8x2048": (("timings", "rms_norm", "rms_decode"), ("ms",)),
    "kernel1_ms_12288x2048": (("timings", "rms_norm", "rms_train"),
                              ("ms",)),
    "kernel1_ms_16x2048": (("timings", "rms_norm", "rms_serve_decode"),
                           ("ms",)),
    "kernel2_ms_generate": (("timings", "flash_attention_fwd",
                             "main_causal"), ("ms",)),
    "kernel2_ms_serve": (("timings", "flash_attention_fwd",
                          "serve_b1_s1024"), ("ms",)),
    "kernel2_ms_train": (("timings", "flash_attention_fwd",
                          "train_causal_with_lse"), ("ms",)),
    "kernel3_ms": (("timings", "flash_attention_bwd_dkdv", "train_causal"),
                   ("ms",)),
    "kernel4_ms": (("timings", "flash_attention_bwd_dq", "train_causal"),
                   ("ms",)),
    "sdpa_backward_ms": (("timings", "flash_attention_bwd_dq",
                          "train_causal"), ("library_ms",)),
    "kernel5_ms_generate": (("timings", "decode_attention_dense",
                             "main_ragged"), ("ms",)),
    "kernel5_ms_full_live": (("timings", "decode_attention_dense",
                              "full_live"), ("ms",)),
    "kernel6_ms": (("timings", "decode_attention_dense_int8",
                    "generate_int8_ragged"), ("ms",)),
    "kernel6_ms_full_live": (("timings", "decode_attention_dense_int8",
                              "full_live_int8"), ("ms",)),
    "kernel7_ms": (("timings", "paged_decode_attention", "serve_ragged"),
                   ("ms",)),
    "kernel7_int8_ms": (("timings", "paged_decode_attention_int8",
                         "serve_int8_ragged"), ("ms",)),
    "kernel7_ms_full_live": (("timings", "paged_decode_attention",
                              "full_live"), ("ms",)),
    "kernel7_int8_ms_full_live": (("timings", "paged_decode_attention_int8",
                                   "full_live_int8"), ("ms",)),
}
# The MLA and MoE serve lines: (model, cache) -> metric prefix.
for (_model, _cache), _name in {
        ("shellac-mla-2b", "paged"): "mla_2b_serve",
        ("shellac-mla-2b", "paged-int8"): "mla_2b_serve_int8",
        ("deepseek-v2-lite", "paged"): "deepseek_v2_lite_serve"}.items():
    for _f in ("tokens_per_s", "tpot_ms_p50", "decode_step_device_ms",
               "decode_step_by_kind"):
        METRICS[f"{_name}_{_f}"] = (("mla", "serve", _model, _cache), (_f,))
for _f in ("tokens_per_s", "tpot_ms_p50", "decode_step_device_ms"):
    METRICS[f"moe_serve_{_f}"] = (("moe", "serve", "gpt-oss-20b", None),
                                  (_f,))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "smoke_ab")
    ap.add_argument("--only", default=None,
                    help="chip_smoke.py's --only (comma-separated phases)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_smoke_ab: no CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    sides = {"parent": args.parent.resolve(), "new": ROOT}
    runs = {"parent": [], "new": []}
    for n, who in enumerate(("parent", "new", "new", "parent")):
        run = run_smoke(sides[who], args.out / f"smoke_{n}_{who}.jsonl",
                        args.only)
        runs[who].append(run)
        print(json.dumps({"run": n, "side": who, "rc": run["rc"],
                          "ok": run["lines"].get("ok"),
                          "seconds": run["seconds"]}), flush=True)
    for name, (key, fields) in METRICS.items():
        print(json.dumps({"metric": name, **{
            who: [pick(r, key, *fields) for r in rs]
            for who, rs in runs.items()}}), flush=True)
    ok = all(r["rc"] == 0 for rs in runs.values() for r in rs)
    if args.only and "train" not in args.only.split(","):
        return 0 if ok else 1
    key, fields = METRICS["train_first_step_loss"]
    first = pick(runs["parent"][0], key, *fields)
    for r in runs["new"]:
        got = pick(r, key, *fields)
        same = (first is not None and got is not None
                and abs(got - first) <= 1e-3 * abs(first))
        print(json.dumps({"first_step_loss": got, "parent": first,
                          "within_1e-3_relative": same}), flush=True)
        ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
