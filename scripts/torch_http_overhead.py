"""Where the HTTP server's host time goes, on the card.

    python3 scripts/torch_http_overhead.py [--seed 0] [--rounds 2]

`chip_smoke.py`'s serve workload (shellac-1b, 16 slots, max_len 2048,
16-token blocks, one tick a window, greedy; 48 requests, prompts
64-1024, 16-128 new tokens), run six ways, in rounds that reverse the
order each time (A B C D E F, then F E D C B A):

  A. in process: `PagedBatchingEngine.run` on all 48 (the `serve` phase);
  B. over HTTP as `chip_smoke.py`'s `http-serve`: `InferenceServer` and
     `make_http_server`, 16 urllib client threads in this process (32
     `/generate`, 8 streamed, 8 `/v1/completions`);
  C. B with the flight recorder off (`debug=False`);
  D. B with the 16 client threads in another process;
  E. B with the interpreter's switch interval at 0.5 ms (5 ms default);
  F. A with the engine's metrics off (a disabled `Registry`: every
     write returns at once), so A against F prices the per-step writes.

Each HTTP way gets a fresh engine and two warm-up requests (its scheduler
thread captures the decode graph). Every way's tokens must equal A's.
One JSON line per run: tokens/s, the engine's step breakdown (ms a step
in each phase, the wall outside the steps, from `shellac_step_phase_
seconds`; none for F) and TPOT p50/p99 (A and F: each request's
clocks; B-E: the server's `shellac_tpot_seconds` histogram,
bucket-interpolated), with the card's name and power limit. `--ways
A,F` runs only those ways (A always runs: it is the tokens' reference).
`--model tiny --device cpu --requests 12 --slots 4 --max-len 128
--clients 4` runs it on the CPU as a smoke test.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KINDS = ("generate",) * 4 + ("stream", "completions")


def client_jobs(base, jobs, n_threads):
    """Run (rid, tokens, max_new, kind) jobs from `n_threads` urllib
    threads; returns ({rid: tokens}, wall seconds)."""
    import urllib.request

    todo = queue.Queue()
    for j in jobs:
        todo.put(j)
    out = {}

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.read()

    def worker():
        while True:
            try:
                rid, toks, m, kind = todo.get_nowait()
            except queue.Empty:
                return
            if kind == "completions":
                body = post("/v1/completions", {"prompt": toks,
                                                "max_tokens": m,
                                                "temperature": 0})
                out[rid] = json.loads(json.loads(body)["choices"][0]["text"])
            else:
                body = post("/generate", {"tokens": toks, "max_new": m,
                                          "stream": kind == "stream"})
                rec = json.loads(body.splitlines()[-1])
                out[rid] = rec["tokens"]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--model", default="shellac-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--ways", default="A,B,C,D,E,F",
                    help="comma-separated letters of the ways to run")
    ap.add_argument("--client", default=None,
                    help="(internal) run the client half against this URL, "
                         "jobs as JSON on stdin")
    args = ap.parse_args()
    if args.client is not None:
        jobs = json.loads(sys.stdin.read())
        out, wall = client_jobs(args.client, jobs, args.clients)
        print(json.dumps({"tokens": out, "wall_s": wall}))
        return 0

    import torch

    import chip_smoke as cs
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import Registry

    dev = torch.device(args.device)
    card = (cs.card_line() if dev.type == "cuda" else "cpu")
    cfg = get_model_config(args.model)
    params = transformer.init_params(cfg, seed=args.seed, device=dev)
    # serve's ranges, cut to fit a smaller --max-len (the CPU smoke).
    hi, new_hi = (min(cs.PROMPT_HI, args.max_len // 2),
                  min(cs.NEW_HI, args.max_len // 4))
    reqs = cs.serve_requests(args.seed + 1, cfg.vocab_size, args.requests,
                             (min(cs.PROMPT_LO, hi), hi),
                             (min(cs.NEW_LO, new_hi), new_hi))
    warm = cs.serve_requests(args.seed + 2, cfg.vocab_size, 2,
                             (cs.PROMPT_LO, cs.PROMPT_LO),
                             (cs.NEW_LO, cs.NEW_LO))
    jobs = [(rid, toks.tolist(), m, KINDS[i % len(KINDS)])
            for i, (rid, toks, m) in enumerate(reqs)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def engine(reg):
        return PagedBatchingEngine(
            cfg, params, n_slots=args.slots, max_len=args.max_len,
            block_size=cs.BLOCK, decode_ticks=1, temperature=0.0,
            device=dev, registry=reg)

    def in_process(metrics=True):
        reg = Registry(enabled=metrics)
        eng = engine(reg)
        eng.run(warm)
        sync()
        totals0 = cs.step_totals(reg)
        t0 = time.perf_counter()
        res = eng.run(reqs)
        sync()
        wall = time.perf_counter() - t0
        tpot = [(t[3] - t[2]) / max(m - 1, 1) for (rid, _, m), t in
                ((r, eng.finished_timings[r[0]]) for r in reqs)]
        return res, wall, cs.step_breakdown(
            totals0, cs.step_totals(reg), wall), {
                "p50": cs.pct(tpot, 50) * 1e3,
                "p99": cs.pct(tpot, 99) * 1e3}

    def over_http(debug=True, process=False, switch=None):
        reg = Registry()
        srv = InferenceServer(cfg, params, engine=engine(reg), registry=reg,
                              debug=debug)
        httpd = make_http_server(srv, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        old = sys.getswitchinterval()
        try:
            client_jobs(base, [(rid, t.tolist(), m, "generate")
                               for rid, t, m in warm], 2)
            sync()
            totals0 = cs.step_totals(reg)
            if switch is not None:
                sys.setswitchinterval(switch)
            if process:
                t0 = time.perf_counter()
                done = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--client",
                     base, "--clients", str(args.clients)],
                    input=json.dumps(jobs), capture_output=True, text=True,
                    check=True)
                wall_outer = time.perf_counter() - t0
                got = json.loads(done.stdout)
                # The client's own wall, from its first request: its
                # process start-up is not the server's time.
                res, wall = got["tokens"], got["wall_s"]
                extra = {"client_process_wall_s": wall_outer}
            else:
                res, wall = client_jobs(base, jobs, args.clients)
                extra = {}
        finally:
            sys.setswitchinterval(old)
        breakdown = cs.step_breakdown(totals0, cs.step_totals(reg), wall)
        tpot = {q: 1e3 * (reg.get("shellac_tpot_seconds").percentile(
            p) or 0.0) for q, p in (("p50", 0.5), ("p99", 0.99))}
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        return res, wall, breakdown, dict(tpot, **extra)

    ways = {
        "A_in_process": in_process,
        "B_http": over_http,
        "C_http_no_recorder": lambda: over_http(debug=False),
        "D_http_clients_in_a_process": lambda: over_http(process=True),
        "E_http_switch_0.5ms": lambda: over_http(switch=5e-4),
        "F_in_process_metrics_off": lambda: in_process(metrics=False),
    }
    order = [w for w in ways if w[0] == "A"
             or w[0] in args.ways.split(",")]
    ref = None
    ok = True
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            res, wall, breakdown, tpot = ways[name]()
            res = {k: list(v) for k, v in res.items()}
            if ref is None and name == "A_in_process":
                ref = res
            generated = sum(len(v) for v in res.values())
            equal = ref is None or res == ref
            ok = ok and equal
            print(json.dumps({
                "way": name, "round": rnd, "model": args.model,
                "slots": args.slots, "requests": len(reqs),
                "tokens_per_s": generated / wall, "wall_s": wall,
                "tokens_equal_to_in_process": equal,
                "tpot_ms": tpot, "step_breakdown": breakdown,
                "card": card}), flush=True)
            cs.gc.collect()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
