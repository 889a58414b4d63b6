"""Serving with and without the admission and decode pipelines, on the
card.

    python3 scripts/torch_serve_pipelines.py [--seed 0] [--ways S,P,O,H1,H0,HS]
        [--profile] [--rounds 1] [--tune 0]

`chip_smoke.py`'s serve workload (shellac-1b, 16 slots, max_len 2048,
16-token blocks, one tick a window, greedy; 48 requests submitted up
front, prompts 64-1024, 16-128 new tokens), run these ways on one
engine configuration each, with fresh engines over the same weights:

  S.  in process, strict ordering, no prefill cap: `chip_smoke.py`'s
      `serve` phase (prefills and windows as graph replays). Its tokens
      are every way's reference.
  P.  S with the prefills run eagerly (the windows still graphs): how
      serving ran before the prefill graphs.
  O.  in process with the reference `serve`'s scheduling: both overlap
      pipelines and one prefill an engine step.
  O0. O without the prefill cap.
  H1. over HTTP as `chip_smoke.py`'s `http-serve` (16 urllib client
      threads in this process: 32 `/generate`, 8 streamed, 8
      `/v1/completions`) with O's scheduling.
  H0. H1 without the prefill cap.
  HS. H1 in strict ordering without the cap: how http-serve ran before.

In-process ways print tokens/s, TTFT (admission to first token, and
submit to first token) and TPOT p50/p99 from each request's clocks, the
engine's step breakdown (ms a step in each phase, from
`shellac_step_phase_seconds`), the wall ms of 20 decode-only steps with
16 slots decoding and the device ms of one such step (torch.profiler),
so the busy share, the window graph's wall on the card when replayed
back to back (CUDA events: its kernels and the gaps between them, no
host work), peak device memory and the graphs captured. HTTP
ways print tokens/s, the server's TTFT, queue wait, TPOT and e2e
p50/p99 from each request's flight-recorder timeline, and the step
breakdown. Every way's tokens must equal S's. `--profile` reruns each
way with a sampling profiler on the thread that drives the engine (the
server's scheduler thread, or the main thread in process): its Python
stack every 0.5 ms, printed as the share of samples in each innermost
function and with each function on the stack. `--rounds N` repeats the
ways, reversing their order each round. `--tune N` then runs the
startup decode_ticks sweep (`autotune_decode_ticks`, its default
candidates) N times, each on a fresh engine with O's scheduling, and
prints each candidate's measured tokens/s and timed seconds, the winner
and the sweep's wall seconds. The card's name and power limit
are on every line. `--model tiny --device cpu --requests 12 --slots 4
--max-len 256` runs it on the CPU as a smoke test (no profiler device
times there: the busy share is left out).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WAYS = {
    "S": dict(kind="local"),
    "P": dict(kind="local", eager_prefill=True),
    "O": dict(kind="local", sched=cs.PIPELINED),
    "O0": dict(kind="local", sched=dict(cs.PIPELINED,
                                        max_prefills_per_step=None)),
    "H1": dict(kind="http", sched=cs.PIPELINED),
    "H0": dict(kind="http", sched=dict(cs.PIPELINED,
                                       max_prefills_per_step=None)),
    "HS": dict(kind="http", sched={}),
}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def make_engine(a, cfg, params, dev, way, reg):
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine

    cls = PagedBatchingEngine
    if way.get("eager_prefill"):
        class EagerPrefill(PagedBatchingEngine):
            def _prefill_replay(self, key):
                return self._program(key)
        cls = EagerPrefill
    return cls(cfg, params, n_slots=a.slots, max_len=a.max_len,
               block_size=16, cache_backend="paged", decode_ticks=1,
               temperature=0.0, device=dev, registry=reg,
               **way.get("sched", {}))


def p50_99(xs):
    return {"p50": cs.pct(xs, 50) * 1e3, "p99": cs.pct(xs, 99) * 1e3}


def local_way(a, name, cfg, params, dev, reqs, warm, profile=False):
    from shellac_tpu_torch.obs import Registry

    reg = Registry()
    eng = make_engine(a, cfg, params, dev, WAYS[name], reg)
    eng.run(warm)
    sync(dev)
    if dev.type == "cuda":
        cs.reset_peak()
    totals0 = cs.step_totals(reg)
    sampler = ThreadSampler(threading.get_ident()) if profile else None
    t0 = time.perf_counter()
    results = eng.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    if profile:
        prof = sampler.stop()
        rec = dict(way=name + "+sampled", tokens_per_s=sum(
            len(v) for v in results.values()) / wall, wall_s=wall,
            step_breakdown=cs.step_breakdown(totals0, cs.step_totals(reg),
                                             wall),
            scheduler_profile=prof)
        eng.abort_all()
        eng.close()
        return results, rec
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    ttft, queued, tpot = [], [], []
    for rid, _, m in reqs:
        tq, ta, tf, td = eng.finished_timings[rid]
        ttft.append(tf - ta)
        queued.append(tf - tq)
        tpot.append((td - tf) / max(m - 1, 1))
    gen = sum(len(v) for v in results.values())
    rec = dict(way=name, tokens_per_s=gen / wall, wall_s=wall,
               ttft_ms=p50_99(ttft), ttft_queued_ms=p50_99(queued),
               tpot_ms=p50_99(tpot), max_memory_allocated=peak,
               step_breakdown=cs.step_breakdown(totals0,
                                                cs.step_totals(reg), wall))
    full = cs.serve_requests(a.seed + 3, cfg.vocab_size, a.slots,
                             (a.prompt_hi // 2, a.prompt_hi // 2),
                             (a.new_hi // 2, a.new_hi // 2))
    cs.fill_decoding(eng, full)
    walls = cs.decode_step_walls(eng)
    rec["wall_ms_per_tick_p50"] = float(np.median(walls))
    if dev.type == "cuda":
        prof = cs.profile_call(eng.step)
        rec["device_ms_per_step"] = prof["device_ms"]
        rec["device_busy_share"] = prof["device_ms"] / float(
            np.median(walls))
        # The window graph replayed back to back: its wall on the card,
        # kernels and the gaps between them, with no host work between
        # windows (the slots decode on; abort_all resets them after).
        graph = eng._window_graphs[1, True, False, False, False, False].graph
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        ev0.record()
        for _ in range(20):
            graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        rec["window_replay_ms_back_to_back"] = ev0.elapsed_time(ev1) / 20
    rec["graphs"] = {"decode": eng.stats["decode_graphs"],
                     "prefill": cs.prefill_graphs(eng)}
    eng.abort_all()
    eng.close()
    return results, rec


class ThreadSampler:
    """A sampling profiler of ONE thread: every `interval` seconds it
    reads the thread's Python stack (`sys._current_frames`) and counts
    the innermost frame and every frame on the stack. (cProfile cannot
    do this: since Python 3.12 it profiles every thread into one stack.)
    A thread blocked in native code (a CUDA event wait, a lock, the GIL)
    shows the Python call that blocked."""

    def __init__(self, thread_id, interval=0.0005):
        self.thread_id, self.interval = thread_id, interval
        self.samples, self.leaf, self.stack = 0, {}, {}
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    @staticmethod
    def _name(code):
        file = code.co_filename
        file = (os.path.relpath(file, REPO) if file.startswith(REPO)
                else os.path.basename(file))
        return f"{file}:{code.co_firstlineno}:{code.co_name}"

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            # Only this thread writes the counts; stop() reads them after
            # joining it.
            self.samples += 1  # shellac: ignore[SH010]
            leaf = self._name(frame.f_code)
            self.leaf[leaf] = self.leaf.get(leaf, 0) + 1
            seen = set()
            while frame is not None:
                name = self._name(frame.f_code)
                if name not in seen:
                    seen.add(name)
                    self.stack[name] = self.stack.get(name, 0) + 1
                frame = frame.f_back

    def stop(self, top=30):
        self._stop.set()
        self._t.join(timeout=5)
        n = max(self.samples, 1)

        def rows(d):
            return [{"fn": k, "share": v / n}
                    for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]

        return {"samples": self.samples, "leaf": rows(self.leaf),
                "on_stack": rows(self.stack)}


def http_way(a, name, cfg, params, dev, reqs, warm, profile):
    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.obs import FlightRecorder, Registry

    reg = Registry()
    eng = make_engine(a, cfg, params, dev, WAYS[name], reg)
    srv = InferenceServer(cfg, params, engine=eng, registry=reg,
                          recorder=FlightRecorder(capacity=1 << 16,
                                                  registry=reg))
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    for _, toks, m in warm:
        cs.http_call(base, "/generate", {"tokens": toks.tolist(),
                                         "max_new": m})
    sync(dev)
    totals0 = cs.step_totals(reg)
    jobs = queue.Queue()
    for i, r in enumerate(reqs):
        jobs.put((i, *r))
    out = {}

    def client():
        while True:
            try:
                i, rid, toks, m = jobs.get_nowait()
            except queue.Empty:
                return
            kind = cs.HTTP_KINDS[i % len(cs.HTTP_KINDS)]
            if kind == "completions":
                _, hdr, body, _ = cs.http_call(
                    base, "/v1/completions",
                    {"prompt": toks.tolist(), "max_tokens": m,
                     "temperature": 0})
                tokens = json.loads(json.loads(body)["choices"][0]["text"])
            else:
                _, hdr, body, _ = cs.http_call(
                    base, "/generate", {"tokens": toks.tolist(),
                                        "max_new": m,
                                        "stream": kind == "stream"},
                    stream=kind == "stream")
                tokens = json.loads(body.splitlines()[-1])["tokens"]
            out[rid] = (tokens, hdr.get("x-request-id"))

    sampler = ThreadSampler(srv._thread.ident) if profile else None
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(a.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    prof = sampler.stop() if profile else None
    breakdown = cs.step_breakdown(totals0, cs.step_totals(reg), wall)
    server = {"ttft": [], "queue_wait": [], "tpot": [], "e2e": []}
    for _, trace_id in out.values():
        _, _, body, _ = cs.http_call(base, f"/debug/request/{trace_id}")
        ev = {e["event"]: e for e in json.loads(body)["events"]}
        ttft, e2e = ev["first-token"]["ttft_s"], ev["finish"]["e2e_s"]
        server["ttft"].append(ttft)
        server["queue_wait"].append(ev["prefill"]["queue_wait_s"])
        server["e2e"].append(e2e)
        server["tpot"].append((e2e - ttft)
                              / max(ev["finish"]["n_tokens"] - 1, 1))
    graphs = {"decode": eng.stats["decode_graphs"],
              "prefill": cs.prefill_graphs(eng)}
    srv.close()
    httpd.shutdown()
    httpd.server_close()
    gen = sum(len(t) for t, _ in out.values())
    rec = dict(way=name + ("+sampled" if profile else ""),
               tokens_per_s=gen / wall, wall_s=wall,
               **{f"server_{k}_ms": p50_99(v) for k, v in server.items()},
               step_breakdown=breakdown, graphs=graphs)
    if profile:
        rec["scheduler_profile"] = prof
    return {rid: t for rid, (t, _) in out.items()}, rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ways", default="S,P,O,O0,H1,H0,HS")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tune", type=int, default=0)
    ap.add_argument("--model", default="shellac-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=cs.REQUESTS)
    ap.add_argument("--slots", type=int, default=cs.SLOTS)
    ap.add_argument("--max-len", type=int, default=cs.MAX_LEN,
                    dest="max_len")
    ap.add_argument("--clients", type=int, default=cs.HTTP_CLIENTS)
    a = ap.parse_args()
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops.dispatch import resolve_device

    dev = resolve_device(a.device)
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    scale = a.max_len / cs.MAX_LEN
    a.prompt_hi = max(16, int(cs.PROMPT_HI * scale))
    a.new_hi = max(64, int(cs.NEW_HI * scale))
    prompt_lo = max(8, int(cs.PROMPT_LO * scale))
    cfg = get_model_config(a.model)
    params = transformer.init_params(cfg, seed=a.seed, device=dev)
    reqs = cs.serve_requests(a.seed + 1, cfg.vocab_size, a.requests,
                             (prompt_lo, a.prompt_hi), (cs.NEW_LO, a.new_hi))
    cs.PROMPT_HI = a.prompt_hi
    warm = cs.warm_requests(a.seed + 2, cfg.vocab_size)
    ways = [w for w in a.ways.split(",") if w]
    if "S" not in ways:
        ways.insert(0, "S")
    ref = None
    failed = []
    for r in range(a.rounds):
        order = ways if r % 2 == 0 else ways[::-1]
        for name in order:
            if WAYS[name]["kind"] == "local":
                results, rec = local_way(a, name, cfg, params, dev, reqs,
                                         warm)
            else:
                results, rec = http_way(a, name, cfg, params, dev, reqs,
                                        warm, False)
            if ref is None and name == "S":
                ref = results
            rec["tokens_equal_to_S"] = (results == ref if ref is not None
                                        else None)
            emit(round=r, card=card, **rec)
            if ref is not None and results != ref:
                failed.append((r, name))
            if dev.type == "cuda":
                cs.reset_peak()
    if a.profile:
        for name in ways:
            run = local_way if WAYS[name]["kind"] == "local" else http_way
            results, rec = run(a, name, cfg, params, dev, reqs, warm, True)
            rec["tokens_equal_to_S"] = results == ref
            emit(card=card, **rec)
    for r in range(a.tune):
        from shellac_tpu_torch.inference.autotune import (
            autotune_decode_ticks,
        )
        from shellac_tpu_torch.obs import Registry

        eng = make_engine(a, cfg, params, dev, WAYS["O"], Registry())
        t0 = time.perf_counter()
        res = autotune_decode_ticks(eng)
        sync(dev)
        emit(card=card, way="tune", repeat=r, decode_ticks=res.best,
             tokens_per_s={str(k): v for k, v in res.measurements.items()},
             timed_s={str(k): v for k, v in res.elapsed.items()},
             sweep_s=time.perf_counter() - t0)
        eng.close()
    if failed:
        raise SystemExit(f"tokens differ from S's: {failed}")


if __name__ == "__main__":
    main()
